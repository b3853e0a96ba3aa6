"""PyTorch port, detection data and evaluation on the CPU against the JAX
package:
  - data/detection.py: poly_to_obb, parse_dota_annfile (headers, unknown
    classes, difficult objects), DOTADataset on a PNG folder the test
    writes, SyntheticDetection and detection_collate (CPU tensors, the
    same values);
  - tasks/map_eval.py (evaluate_map on axis-aligned and rotated boxes, all
    point and 11-point AP; evaluate_mask_map) and tasks/dota.py
    (write_dota_submission byte for byte); JAX's rotated IoU there runs
    its jnp op (its native library's loader patched to None, so no make
    runs), the port's through its own leme_ops library;
  - data/dota_split.py: iter_windows, split_image's tiles, nms_rotated_np,
    merge_tile_detections, TiledDOTADataset and cli.dota_split's output
    tree, file for file and byte for byte;
  - cli.train_det --device cpu on original-size images with --tile (the
    merge) and with --format-only (the submission files)."""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from lemevit_tpu.cli import dota_split as j_dota_split_cli
from lemevit_tpu.data import detection as JDet
from lemevit_tpu.data import dota_split as JSplit
from lemevit_tpu.ops import native as j_native
from lemevit_tpu.tasks import dota as JDota
from lemevit_tpu.tasks import map_eval as JMap
from lemevit_tpu_torch.cli import dota_split as dota_split_cli
from lemevit_tpu_torch.cli import train_det
from lemevit_tpu_torch.data import detection as Det
from lemevit_tpu_torch.data import dota_split as Split
from lemevit_tpu_torch.ops import native
from lemevit_tpu_torch.tasks import dota as Dota
from lemevit_tpu_torch.tasks import map_eval as Map

CLASSES = JDota.DOTA10_CLASSES


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_without_native(monkeypatch):
    """JAX's map_eval on its jnp rotated IoU: no make of native/."""
    monkeypatch.setattr(j_native, "_load", lambda: None)


def rect_poly(cx, cy, w, h, t):
    c, s = np.cos(t), np.sin(t)
    pts = [(cx + dx * c - dy * s, cy + dx * s + dy * c)
           for dx, dy in ((-w / 2, -h / 2), (w / 2, -h / 2), (w / 2, h / 2),
                          (-w / 2, h / 2))]
    return np.asarray(pts, np.float64).reshape(8)


def random_polys(n, seed, w=300, h=260):
    rs = np.random.RandomState(seed)
    return np.stack([rect_poly(rs.uniform(20, w - 20), rs.uniform(20, h - 20),
                               rs.uniform(10, 60), rs.uniform(10, 60),
                               rs.uniform(-1.4, 1.4)) for _ in range(n)])


def write_original(root, split, stem, seed, w=300, h=260, n=6):
    """One original-size image and its annotation file (DOTA's header
    lines, a difficult object, an unknown class)."""
    from PIL import Image
    rs = np.random.RandomState(seed)
    (root / split / "images").mkdir(parents=True, exist_ok=True)
    (root / split / "annfiles").mkdir(parents=True, exist_ok=True)
    Image.fromarray(rs.randint(0, 256, (h, w, 3), np.uint8)).save(
        root / split / "images" / f"{stem}.png")
    lines = ["imagesource:GoogleEarth", "gsd:0.15"]
    for i, p in enumerate(random_polys(n, seed, w, h)):
        cls = CLASSES[rs.randint(0, len(CLASSES))] if i else "not-a-class"
        lines.append(" ".join(f"{v:.1f}" for v in p)
                     + f" {cls} {int(i == 2)}")
    (root / split / "annfiles" / f"{stem}.txt").write_text(
        "\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def dota_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dota")
    for seed, (split, stem) in enumerate((("train", "P0001"),
                                          ("train", "P0002"),
                                          ("val", "P0003"))):
        write_original(root, split, stem, seed)
    return root


def same_items(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# --------------------------------------------------------- annotations

def test_poly_to_obb():
    for p in random_polys(20, 0):
        np.testing.assert_array_equal(Det.poly_to_obb(p),
                                      JDet.poly_to_obb(p))


@pytest.mark.parametrize("skip_difficult", [False, True])
def test_parse_dota_annfile(dota_root, skip_difficult):
    path = str(dota_root / "train" / "annfiles" / "P0001.txt")
    same_items(Det.parse_dota_annfile(path, skip_difficult=skip_difficult),
               JDet.parse_dota_annfile(path, skip_difficult=skip_difficult))
    obbs, labels = Det.parse_dota_annfile(path,
                                          skip_difficult=skip_difficult)
    assert len(labels) == (4 if skip_difficult else 5)


def test_dota_dataset(dota_root):
    got = Det.DOTADataset(str(dota_root), "train")
    want = JDet.DOTADataset(str(dota_root), "train")
    assert got.names == want.names
    for i in range(len(want)):
        same_items(got[i], want[i])


def test_synthetic_detection_and_collate():
    got, want = Det.SyntheticDetection(4, 64, 5), JDet.SyntheticDetection(
        4, 64, 5)
    samples = [want[i] for i in range(4)]
    for i in range(4):
        same_items(got[i], samples[i])
    b = Det.detection_collate(samples, max_boxes=6)
    jb = JDet.detection_collate(samples, max_boxes=6)
    assert set(b) == set(jb)
    assert b["image"].dtype == torch.uint8 and b["gt_mask"].dtype == \
        torch.bool and b["gt_labels"].dtype == torch.int64
    for k in jb:
        np.testing.assert_array_equal(b[k].numpy(), jb[k])


# ---------------------------------------------------------- evaluation

def detections(seed, rotated, n_img=3, n_cls=3):
    """Per image one gt of each class and two noisy detections of each
    (one pair of shapes for every IoU matrix: JAX compiles its op once)."""
    rs = np.random.RandomState(seed)
    dets, gts = {}, {}
    k = n_cls
    for i in range(n_img):
        if rotated:
            g = np.stack([rs.uniform(20, 200, k), rs.uniform(20, 200, k),
                          rs.uniform(10, 50, k), rs.uniform(10, 50, k),
                          rs.uniform(-1, 1, k)], -1)
            noise = [8, 8, 6, 6, 0.3]
        else:
            lt = rs.uniform(0, 200, (k, 2))
            g = np.concatenate([lt, lt + rs.uniform(10, 50, (k, 2))], 1)
            noise = 8
        d = np.repeat(g, 2, 0) + rs.normal(0, noise, (2 * k, g.shape[1]))
        dets[f"img{i}"] = {"boxes": d.astype(np.float32),
                           "scores": rs.rand(2 * k).astype(np.float32),
                           "labels": np.repeat(np.arange(k), 2)}
        gts[f"img{i}"] = {"boxes": g.astype(np.float32),
                          "labels": np.arange(k, dtype=np.int32)}
    return dets, gts


@pytest.mark.parametrize("rotated,mode", [(False, "area"), (True, "area"),
                                          (True, "11points")])
def test_evaluate_map(jax_without_native, rotated, mode):
    dets, gts = detections(1, rotated)
    got = Map.evaluate_map(dets, gts, 3, mode=mode)
    want = JMap.evaluate_map(dets, gts, 3, mode=mode)
    assert set(got) == set(want) and 0 < want["mAP"] < 1
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k
    if rotated:
        assert native.available()  # the port's IoU ran in its leme_ops


def test_evaluate_mask_map():
    rs = np.random.RandomState(2)
    gts = {"a": {"masks": rs.rand(3, 16, 16) > 0.6,
                 "labels": np.array([0, 1, 1])}}
    noisy = gts["a"]["masks"][[0, 1, 2, 1]] ^ (rs.rand(4, 16, 16) > 0.9)
    dets = {"a": {"masks": noisy, "scores": rs.rand(4),
                  "labels": np.array([0, 1, 1, 0])}}
    got = Map.evaluate_mask_map(dets, gts, 2)
    assert got == pytest.approx(JMap.evaluate_mask_map(dets, gts, 2))


def test_write_dota_submission(tmp_path):
    dets, _ = detections(3, True)
    for d in dets.values():
        d["labels"] = d["labels"] * 5  # spread over the 15 classes
    got = Dota.write_dota_submission(str(tmp_path / "port"), dets)
    want = JDota.write_dota_submission(str(tmp_path / "jax"), dets)
    assert [Path(p).name for p in got] == [Path(p).name for p in want]
    assert len(got) == 15
    for g, w in zip(got, want):
        assert Path(g).read_bytes() == Path(w).read_bytes()
    np.testing.assert_array_equal(
        Dota.obb_to_poly_np(dets["img0"]["boxes"]),
        JDota.obb_to_poly_np(dets["img0"]["boxes"]))


# ----------------------------------------------------------- splitting

@pytest.mark.parametrize("w,h,size,gap", [(300, 260, 128, 32),
                                          (100, 90, 128, 32),
                                          (1500, 1300, 1024, 200)])
def test_iter_windows(w, h, size, gap):
    assert Split.iter_windows(w, h, size, gap) == JSplit.iter_windows(
        w, h, size, gap)


def test_split_image():
    rs = np.random.RandomState(4)
    img = rs.randint(0, 256, (260, 300, 3), np.uint8)
    polys = random_polys(12, 4).astype(np.float32)
    labels = rs.randint(0, 15, 12).astype(np.int32)
    got = Split.split_image(img, polys, labels, 128, 32, 0.7, True)
    want = JSplit.split_image(img, polys, labels, 128, 32, 0.7, True)
    assert len(got) == len(want) > 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_nms_rotated_np_and_merge():
    rs = np.random.RandomState(5)
    base = np.stack([rs.uniform(20, 300, 10), rs.uniform(20, 300, 10),
                     rs.uniform(10, 60, 10), rs.uniform(10, 60, 10),
                     rs.uniform(-1, 1, 10)], -1)
    boxes = np.concatenate([base, base + rs.normal(0, 3, (10, 5))])
    scores = rs.rand(20).astype(np.float32)
    np.testing.assert_array_equal(Split.nms_rotated_np(boxes, scores, 0.1),
                                  JSplit.nms_rotated_np(boxes, scores, 0.1))
    entries = []
    for x0, y0 in ((0, 0), (96, 0), (0, 96)):
        sel = slice(x0 // 16, x0 // 16 + 10)
        b = boxes[sel].copy()
        b[:, 0] -= x0
        b[:, 1] -= y0
        entries.append((Split.tile_name("P9", x0, y0), b.astype(np.float32),
                        scores[sel], rs.randint(0, 3, 10)))
    got = Split.merge_tile_detections(entries, 0.1)
    want = JSplit.merge_tile_detections(entries, 0.1)
    assert got.keys() == want.keys() == {"P9"}
    for k in want["P9"]:
        np.testing.assert_array_equal(got["P9"][k], want["P9"][k])


def test_dota_split_cli_tree(dota_root, tmp_path):
    argv = ["--src", str(dota_root), "--size", "128", "--gap", "32"]
    got = dota_split_cli.main(argv + ["--dst", str(tmp_path / "port")])
    want = j_dota_split_cli.main(argv + ["--dst", str(tmp_path / "jax")])
    assert got == want and got["train"] > 4
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*")
                           if p.is_file())
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (
            tmp_path / "jax" / f).read_bytes(), f


@pytest.mark.parametrize("keep_empty", [False, True])
def test_tiled_dataset(dota_root, keep_empty):
    kw = dict(size=128, gap=32, iof_thr=0.7, keep_empty=keep_empty)
    got = Split.TiledDOTADataset(str(dota_root), "train", **kw)
    want = JSplit.TiledDOTADataset(str(dota_root), "train", **kw)
    assert got.names == want.names and len(got) > 4
    for i in range(len(want)):
        same_items(got[i], want[i])
    og, ow = got.original_gts(), want.original_gts()
    assert og.keys() == ow.keys()
    for k in ow:
        for kk in ow[k]:
            np.testing.assert_array_equal(og[k][kk], ow[k][kk])


# ------------------------------------------------------------ the CLI

DET_FLAGS = ["--device", "cpu", "--backbone", "lemevit_micro",
             "--batch-size", "2", "--epochs", "1", "--steps-per-epoch", "1",
             "--fpn-channels", "16", "--num-proposals", "8",
             "--rpn-nms-pre", "16", "--workers", "1", "--tile",
             "--tile-size", "128", "--tile-gap", "32"]


@pytest.mark.parametrize("backbone", ["lemevit_micro", "resnet18"])
def test_train_det_synthetic_on_cpu(tmp_path, backbone):
    """--synthetic with a LeMeViT and a CNN pyramid under the FPN: a step,
    its eval, the best checkpoint."""
    res = train_det.main(["--synthetic", "--device", "cpu", "--backbone",
                          backbone, "--img-size", "64", "--batch-size", "2",
                          "--epochs", "1", "--steps-per-epoch", "1",
                          "--num-proposals", "8", "--rpn-nms-pre", "16",
                          "--fpn-channels", "16", "--workers", "1",
                          "--output", str(tmp_path)])
    assert res["steps"] == 1 and np.isfinite(res["loss"])
    assert set(res["parts"]) == {"rpn_cls", "rpn_reg", "roi_cls", "roi_reg"}
    assert (tmp_path / "checkpoints" / "checkpoints.json").exists()


def test_train_det_tile_merge_on_cpu(dota_root, tmp_path):
    """--tile on original-size images: tiles on the fly, the eval merges
    the tiles' detections back to the original image (mAP over its
    ground truth) and keeps the best checkpoint."""
    res = train_det.main(DET_FLAGS + ["--data-dir", str(dota_root),
                                      "--output", str(tmp_path)])
    assert res["steps"] == 1 and np.isfinite(res["loss"])
    assert 0 <= res["best_mAP"] <= 1
    assert (tmp_path / "checkpoints" / "checkpoints.json").exists()
    assert (tmp_path / "args.yaml").read_text().count("tile: true") == 1


def test_train_det_format_only_on_cpu(dota_root, tmp_path):
    """--format-only writes DOTA's per-class submission files (ids of the
    original images) and no checkpoint."""
    res = train_det.main(DET_FLAGS + ["--data-dir", str(dota_root),
                                      "--output", str(tmp_path),
                                      "--format-only"])
    assert res["best_mAP"] == -1.0
    sub = sorted(os.listdir(tmp_path / "submission"))
    assert sub == sorted(f"Task1_{c}.txt" for c in CLASSES)
    ids = {line.split()[0] for f in sub
           for line in (tmp_path / "submission" / f).read_text().split("\n")
           if line}
    assert ids <= {"P0003"}
    assert not (tmp_path / "checkpoints").exists()
