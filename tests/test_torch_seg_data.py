"""PyTorch port, segmentation data on files: cli/train_seg.py::SegDataset
against the JAX package's (lemevit_tpu/cli/train_seg.py::SegDataset) on an
{train,val}/{images,labels}/*.png folder the test writes (images of four
sizes, some smaller than the crop; palette-free "L" labels with values
past num_classes and 255, and one RGB label file): under the same
``random.seed`` every training item is the same bytes (scale jitter,
crop, flip and the three photometric draws), with and without
``ignore_index``, and so are the eval items; the draws move with the
seed. Then two cli.train_seg --device cpu steps read the folder."""
import random

import numpy as np
import pytest
import torch
from PIL import Image

from lemevit_tpu.cli.train_seg import SegDataset as JSeg
from lemevit_tpu_torch.cli import train_seg
from lemevit_tpu_torch.cli.train_seg import SegDataset

NUM_CLASSES, CROP = 6, 32
SIZES = {"train": [(40, 48), (30, 64), (72, 36), (24, 24)],
         "val": [(40, 40), (36, 52)]}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seg_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg")
    rs = np.random.RandomState(0)
    for split, sizes in SIZES.items():
        (root / split / "images").mkdir(parents=True)
        (root / split / "labels").mkdir(parents=True)
        for i, (h, w) in enumerate(sizes):
            name = f"tile_{i:02d}.png"
            small = rs.randint(0, 256, (h // 4, w // 4, 3), np.uint8)
            Image.fromarray(small).resize((w, h), Image.BILINEAR).save(
                root / split / "images" / name)
            lbl = rs.randint(0, NUM_CLASSES + 2, (h, w)).astype(np.uint8)
            lbl[rs.rand(h, w) < 0.1] = 255
            if split == "train" and i == 1:  # an RGB label file
                Image.fromarray(np.repeat(lbl[..., None], 3, -1)).save(
                    root / split / "labels" / name)
            else:
                Image.fromarray(lbl, "L").save(root / split / "labels" / name)
    return root


def items(cls, root, split, train, ignore_index, seed):
    ds = cls(str(root), split, CROP, NUM_CLASSES, train=train,
             ignore_index=ignore_index)
    random.seed(seed)
    return [ds[i] for i in range(len(ds))]


@pytest.mark.parametrize("ignore_index", [None, 255], ids=["clip", "ignore"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_items_match_jax(seg_root, ignore_index, seed):
    got = items(SegDataset, seg_root, "train", True, ignore_index, seed)
    want = items(JSeg, seg_root, "train", True, ignore_index, seed)
    assert len(got) == len(SIZES["train"])
    for (gi, gm), (wi, wm) in zip(got, want):
        assert gi.dtype == wi.dtype == np.uint8
        assert gi.shape == (CROP, CROP, 3) and gm.shape == (CROP, CROP)
        np.testing.assert_array_equal(gi, wi)
        assert gm.dtype == wm.dtype
        np.testing.assert_array_equal(gm, wm)
        valid = set(range(NUM_CLASSES))
        assert set(np.unique(gm)) <= (valid if ignore_index is None
                                      else valid | {ignore_index})
    if ignore_index is not None:
        assert any((m == ignore_index).any() for _, m in got)
    # the seed moves the draws
    other = items(SegDataset, seg_root, "train", True, ignore_index,
                  seed + 10)
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(got, other))


@pytest.mark.parametrize("ignore_index", [None, 255], ids=["clip", "ignore"])
def test_eval_items_match_jax(seg_root, ignore_index):
    got = items(SegDataset, seg_root, "val", False, ignore_index, 0)
    want = items(JSeg, seg_root, "val", False, ignore_index, 0)
    for (gi, gm), (wi, wm), (h, w) in zip(got, want, SIZES["val"]):
        assert gi.shape == (h, w, 3)  # eval items keep their size
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)


def test_train_seg_cli_reads_the_folder(seg_root, tmp_path):
    res = train_seg.main([
        "--data-dir", str(seg_root), "--device", "cpu", "--backbone",
        "lemevit_micro", "--crop-size", str(CROP), "--batch-size", "2",
        "--channels", "16", "--iters", "2", "--num-classes",
        str(NUM_CLASSES), "--ignore-index", "255", "--eval-stride", "16",
        "--output", str(tmp_path)])
    assert res["steps"] == 2 and np.isfinite(res["loss"])
    assert 0.0 <= res["final_metrics"]["mIoU"] <= 100.0
