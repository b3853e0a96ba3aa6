"""Datasets built inside spawned loader workers; counterpart of
lemevit_tpu/data/spawn.py.

A transform is a closure and does not pickle, so a worker process gets a
``DatasetSpec`` instead, a "module:function" path and primitive keyword
arguments, and builds the dataset in its own fresh interpreter (numpy, PIL
and CPU torch; it never touches CUDA). ``build_split_dataset`` rebuilds
the classification CLIs' dataset and transform; any module-level function
that returns a dataset serves.

Not ported: ``packed`` (ROADMAP queue 1, item 4), ``native`` (item 4) and
``aug_splits`` (item 2) raise NotImplementedError.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass(frozen=True)
class DatasetSpec:
    builder: str  # "module:function"
    kwargs: Dict[str, Any] = field(default_factory=dict)

    def build(self):
        mod_name, fn_name = self.builder.split(":")
        return getattr(importlib.import_module(mod_name), fn_name)(
            **self.kwargs)


def build_split_dataset(dataset: str, data_dir: str, split: str,
                        img_size: int = 224, train: bool = True,
                        hflip: float = 0.5,
                        auto_augment: str = "rand-m9-mstd0.5-inc1",
                        native: bool = False, crop_pct: float = 0.9,
                        aug_splits: int = 0, packed: str = "",
                        scale=(0.08, 1.0)):
    """The dataset and transform of cli/train.py and cli/validate.py, from
    picklable arguments."""
    from lemevit_tpu_torch.data import transforms as T
    from lemevit_tpu_torch.data.datasets import create_dataset

    if packed:
        raise NotImplementedError(
            "packed data is not ported yet (ROADMAP queue 1, item 4)")
    if native:
        raise NotImplementedError(
            "native decode is not ported yet (ROADMAP queue 1, item 4)")
    if aug_splits:
        raise NotImplementedError(
            "aug splits are not ported yet (ROADMAP queue 1, item 2)")
    if train:
        tf = T.build_train_transform(img_size, hflip=hflip,
                                     auto_augment=auto_augment,
                                     scale=tuple(scale))
    else:
        tf = T.build_eval_transform(img_size, crop_pct)
    return create_dataset(dataset, data_dir, split=split, transform=tf)


def spec_for_split(args, split: str, train: bool) -> DatasetSpec:
    """The DatasetSpec of a CLI's ``split``, from its parsed ``args``."""
    return DatasetSpec(
        "lemevit_tpu_torch.data.spawn:build_split_dataset",
        dict(dataset=args.dataset, data_dir=args.data_dir, split=split,
             img_size=args.img_size, train=train,
             hflip=getattr(args, "hflip", 0.5),
             auto_augment=getattr(args, "aa", ""),
             crop_pct=getattr(args, "crop_pct", 0.9),
             scale=tuple(getattr(args, "scale", (0.08, 1.0)))))
