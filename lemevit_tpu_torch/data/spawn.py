"""Datasets built inside spawned loader workers; counterpart of
lemevit_tpu/data/spawn.py.

A transform is a closure and does not pickle, so a worker process gets a
``DatasetSpec`` instead, a "module:function" path and primitive keyword
arguments, and builds the dataset in its own fresh interpreter (numpy, PIL
and CPU torch; it never touches CUDA). ``build_split_dataset`` rebuilds
the classification CLIs' dataset and transform; any module-level function
that returns a dataset serves. ``packed`` gives the split of a packed
cache (data/packed.py; augmentation on the device), ``native`` the native
decode transforms.
"""
from __future__ import annotations

import importlib
import os
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
    picklable arguments.

    ``scale`` (cli.train's --scale, the random resized crop's area range)
    reaches every train transform: the PIL and native ones and the AugMix
    splits', in loader threads and in spawned workers alike, as timm (and
    the reference) honours it. This deviates from the JAX package, whose
    spawned workers (its data/spawn.py has no ``scale``) and AugMix splits
    crop at (0.08, 1.0) whatever --scale says, while its threads honour it
    (ROADMAP queue 3)."""
    from lemevit_tpu_torch.data import transforms as T
    from lemevit_tpu_torch.data.datasets import create_dataset

    if packed:
        from lemevit_tpu_torch.data.packed import PackedDataset
        return PackedDataset(os.path.join(packed, split))
    if train and aug_splits:
        tf = T.build_augsplit_transform(img_size, hflip=hflip,
                                        auto_augment=auto_augment,
                                        num_splits=aug_splits,
                                        scale=tuple(scale))
    elif train:
        build = (T.build_native_train_transform if native
                 else T.build_train_transform)
        tf = build(img_size, hflip=hflip, auto_augment=auto_augment,
                   scale=tuple(scale))
    elif native:
        tf = T.build_native_eval_transform(img_size, crop_pct)
    else:
        tf = T.build_eval_transform(img_size, crop_pct)
    return create_dataset(dataset, data_dir, split=split, transform=tf)


def spec_for_split(args, split: str, train: bool,
                   aug_splits: int = 0) -> DatasetSpec:
    """The DatasetSpec of a CLI's ``split``, from its parsed ``args``; a
    train split with ``aug_splits`` > 1 gives (S, H, W, 3) samples."""
    return DatasetSpec(
        "lemevit_tpu_torch.data.spawn:build_split_dataset",
        dict(dataset=args.dataset, data_dir=args.data_dir, split=split,
             img_size=args.img_size, train=train,
             hflip=getattr(args, "hflip", 0.5),
             auto_augment=getattr(args, "aa", ""),
             native=bool(getattr(args, "native_decode", False)),
             crop_pct=getattr(args, "crop_pct", 0.9), aug_splits=aug_splits,
             packed=getattr(args, "packed_data", ""),
             scale=tuple(getattr(args, "scale", (0.08, 1.0)))))
