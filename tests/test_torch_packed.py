"""PyTorch port, the packed data plane: data/packed.py and cli/pack.py
against the JAX package's pack_folder and PackedDataset, cli.validate
--packed-data against the JAX package's cli.validate (lemevit_micro, 32 px,
fp32, one reference-named checkpoint loaded by both, a ragged last batch;
loss within 2e-4, top-1 and top-5 equal), and cli.train with
--packed-data and --native-decode: a few CPU steps, the same loss on a
rerun and the same weights from 1 and 4 loader threads."""
import json
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from lemevit_tpu.cli import validate as jax_validate
from lemevit_tpu.data import native_decode as JN
from lemevit_tpu.data import packed as JP
from lemevit_tpu_torch.cli import pack as pack_cli
from lemevit_tpu_torch.cli import train as train_cli
from lemevit_tpu_torch.cli import validate
from lemevit_tpu_torch.data import native_decode as N
from lemevit_tpu_torch.data import packed as P
from lemevit_tpu_torch.models.registry import create_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC = 7  # lemevit_micro's classes (JAX's top-5 needs at least 5)
CLASSES = 5
PER_CLASS = {"train": 4, "validation": 3}  # 15 validation images: 4+4+4+3
EXTS = ("jpg", "png", "jpg", "bmp")


def write_picture(path, seed):
    rs = np.random.RandomState(seed)
    h, w = (int(v) for v in rs.randint(30, 70, 2))
    small = rs.randint(0, 256, (h // 6 + 2, w // 6 + 2, 3), np.uint8)
    img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
    if seed % 5 == 2:
        img = img.convert("L")
    img.save(path, **({"quality": 95} if path.suffix == ".jpg" else {}))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """folder/{train,validation}/c<k>/ of JPEGs, PNGs, a greyscale JPEG
    and BMPs (the PIL fallback); a checkpoint of lemevit_micro."""
    root = tmp_path_factory.mktemp("packed")
    k = 0
    for split, n in PER_CLASS.items():
        for c in range(CLASSES):
            d = root / "folder" / split / f"c{c}"
            d.mkdir(parents=True)
            for i in range(n):
                write_picture(d / f"{i}.{EXTS[(k + i) % 4]}", k)
                k += 1
    ckpt = root / "micro.pth"
    torch.save({"state_dict": create_model(
        "lemevit_micro", num_classes=NC, device="cpu", seed=3).state_dict()},
        ckpt)
    return {"root": root, "folder": str(root / "folder"), "ckpt": str(ckpt)}


@pytest.fixture(scope="module")
def packed(data):
    """The folder packed by cli.pack at 40 px and at 35 px."""
    out = {}
    for px in (40, 35):
        dst = data["root"] / f"packed{px}"
        metas = pack_cli.main(["--src", data["folder"], "--out", str(dst),
                               "--px", str(px)])
        assert set(metas) == {"train", "validation"}
        out[px] = str(dst)
    return out


def read(root):
    ds = P.PackedDataset(root)
    return np.stack([ds[i][0] for i in range(len(ds))]), ds.labels, ds.meta


def test_pack_folder_without_the_library_is_jaxs(data, tmp_path,
                                                 monkeypatch):
    """PIL for every image on both sides: the same bytes, labels and meta."""
    monkeypatch.setattr(N, "available", lambda: False)
    monkeypatch.setattr(JN, "available", lambda: False)
    src = os.path.join(data["folder"], "train")
    meta = P.pack_folder(src, str(tmp_path / "port"), px=24)
    jmeta = JP.pack_folder(src, str(tmp_path / "jax"), px=24)
    assert meta == jmeta and meta["n"] == CLASSES * PER_CLASS["train"]
    imgs, labels, _ = read(str(tmp_path / "port"))
    jds = JP.PackedDataset(str(tmp_path / "jax"))
    assert np.array_equal(imgs, np.stack([jds[i][0]
                                          for i in range(len(jds))]))
    assert np.array_equal(labels, jds.labels)


def test_pack_folder_native(data, packed, tmp_path, monkeypatch):
    """The native plane where the library decodes (JAX's bits where its
    library loads here), PIL per image where it does not: the BMPs are
    PIL's bits, the rest within PIL's limits."""
    imgs, labels, meta = read(os.path.join(packed[40], "train"))
    assert imgs.shape == (meta["n"], 40, 40, 3) and imgs.dtype == np.uint8
    assert meta["classes"] == [f"c{c}" for c in range(CLASSES)]
    monkeypatch.setattr(N, "available", lambda: False)
    src = os.path.join(data["folder"], "train")
    P.pack_folder(src, str(tmp_path / "pil"), px=40)
    pil, pil_labels, _ = read(str(tmp_path / "pil"))
    assert np.array_equal(labels, pil_labels)
    ds = P.PackedDataset(os.path.join(packed[40], "train"))
    from lemevit_tpu_torch.data.datasets import ImageFolderDataset
    paths = [p for p, _ in ImageFolderDataset(src).samples]
    for i, path in enumerate(paths):
        d = np.abs(imgs[i].astype(int) - pil[i].astype(int))
        if path.endswith(".bmp"):
            assert d.max() == 0, path
        else:
            assert d.mean() < 3.0 and np.percentile(d, 99) <= 12, path
    assert len(ds) == len(paths)
    if os.path.exists(JN._SO_PATH) and JN.available():
        monkeypatch.undo()
        JP.pack_folder(src, str(tmp_path / "jax"), px=40)
        jds = JP.PackedDataset(str(tmp_path / "jax"))
        assert np.array_equal(imgs, np.stack([jds[i][0]
                                              for i in range(len(jds))]))


def test_packed_dataset_pickles_without_its_memmap(packed):
    root = os.path.join(packed[35], "validation")
    ds = P.PackedDataset(root)
    fresh = pickle.loads(pickle.dumps(ds))
    img, label = ds[3]
    assert ds._mm is not None and img.shape == (35, 35, 3)
    assert "_mm" in ds.__getstate__() and ds.__getstate__()["_mm"] is None
    again = pickle.loads(pickle.dumps(ds))
    assert again._mm is None
    for other in (fresh, again):
        got, lab = other[3]
        assert np.array_equal(got, img) and lab == label
    # the JAX package reads the port's cache as its own
    jds = JP.PackedDataset(root)
    assert len(jds) == len(ds) == CLASSES * PER_CLASS["validation"]
    assert all(np.array_equal(jds[i][0], ds[i][0]) and jds[i][1] == ds[i][1]
               for i in range(len(ds)))


def test_cli_pack_skips_missing_splits(data, tmp_path, capsys):
    metas = pack_cli.main(["--src", data["folder"], "--out", str(tmp_path),
                           "--px", "16", "--splits", "validation", "test"])
    assert list(metas) == ["validation"] and metas["validation"]["px"] == 16
    assert "skip test" in capsys.readouterr().out
    with open(tmp_path / "validation" / "meta.json") as f:
        assert json.load(f)["n"] == CLASSES * PER_CLASS["validation"]


def argv(packed_dir, ckpt, *extra):
    return ["--model", "lemevit_micro", "--img-size", "32",
            "--batch-size", "4", "--num-classes", str(NC),
            "--packed-data", packed_dir, "--checkpoint", ckpt, *extra]


@pytest.mark.parametrize("px", [40, 35])
def test_validate_packed_matches_jax(data, packed, px):
    """At 40 px the squares are resized to int(32 / 0.9) = 35 before the
    centre crop; at 35 px they are not. JAX stops at its last batch
    (--max-batches), as tests/test_torch_data_cli.py::jax_argv does."""
    n = CLASSES * PER_CLASS["validation"]
    want = jax_validate.main(argv(packed[px], data["ckpt"], "--max-batches",
                                  str(-(-n // 4))))
    logits = []
    args = validate.build_parser().parse_args(argv(packed[px], data["ckpt"],
                                                   "--device", "cpu"))
    got = validate.validate(args, logits)
    assert got["count"] == n and [t.shape[0] for t in logits] == [4, 4, 4, 3]
    assert abs(got["loss"] - want["loss"]) <= 2e-4, (got, want)
    assert (got["top1"], got["top5"]) == (want["top1"], want["top5"])


def train(data, out, *extra):
    return train_cli.main([
        "--config", os.path.join(REPO, "configs", "lemevit.yaml"),
        "--model", "lemevit_micro", "--img-size", "32", "--batch-size", "4",
        "--num-classes", str(NC), "--device", "cpu", "--epochs", "1",
        "--steps-per-epoch", "3", "--warmup-epochs", "1", "--output",
        str(out), "--no-auto-resume", "--model-ema-decay", "0.5", *extra])


def weights(out):
    ckpt = next((out / "lemevit_micro" / "checkpoints").glob(
        "checkpoint-*.pth"))
    return torch.load(ckpt, weights_only=False)["state_dict"]


@pytest.mark.parametrize("plane", ["packed", "native"])
def test_train_reruns_and_threads_agree(data, packed, tmp_path, plane):
    """Three steps of the configs/lemevit.yaml recipe (the device
    augmentation or the native decode; mixup, erasing) and an eval: 4
    loader threads and 2 spawned worker processes give the loss and the
    weights of 1 thread."""
    src = (["--packed-data", packed[40]] if plane == "packed" else
           ["--data-dir", data["folder"], "--native-decode"])
    runs = [train(data, tmp_path / f"r{w}", *src, "--workers", str(w))
            for w in (1, 4)]
    for r in runs:
        assert r["steps"] == 3 and np.isfinite(r["train_loss"])
        assert 0 <= r["best_top1"] <= 100
    assert runs[0]["train_loss"] == runs[1]["train_loss"]
    # and 2 spawned worker processes (no eval: it would spawn its own)
    procs = train(data, tmp_path / "p2", *src, "--worker-procs", "2",
                  "--eval-interval", "2")
    assert procs["train_loss"] == runs[0]["train_loss"]
    a = weights(tmp_path / "r1")
    for other in ("r4", "p2"):
        b = weights(tmp_path / other)
        for k, v in a.items():
            assert torch.equal(v, b[k]), (other, k)
    log = (tmp_path / "r1" / "lemevit_micro" / "train.log").read_text()
    assert ("packed data plane" in log) == (plane == "packed")
    assert ("native decode plane on" in log) == (plane == "native")


def test_native_decode_is_on_by_default_where_it_builds(data, tmp_path):
    res = train(data, tmp_path, "--data-dir", data["folder"],
                "--steps-per-epoch", "1", "--eval-interval", "2")
    assert res["steps"] == 1
    log = (tmp_path / "lemevit_micro" / "train.log").read_text()
    assert "native decode plane on" in log


def test_packed_data_refuses_aug_splits(packed, tmp_path):
    with pytest.raises(SystemExit, match="aug-splits"):
        train(None, tmp_path, "--packed-data", packed[40], "--aug-splits",
              "3", "--aa", "augmix-m3-w3")


def test_packed_data_refuses_host_only_policies(packed, tmp_path):
    with pytest.raises(ValueError, match="rand-"):
        train(None, tmp_path, "--packed-data", packed[40], "--aa",
              "augmix-m3-w3")


def test_batch_images_are_decoded_once(packed):
    """The loader hands the packed squares as they are, uint8 (B, px, px,
    3), and the eval crop is their centre."""
    from lemevit_tpu_torch.data.device_aug import center_crop
    from lemevit_tpu_torch.data.loader import create_loader
    ds = P.PackedDataset(os.path.join(packed[40], "validation"))
    batch = next(iter(create_loader(ds, 4, num_threads=2)))
    assert batch["image"].dtype == torch.uint8
    assert batch["image"].shape == (4, 40, 40, 3)
    want = np.stack([ds[i][0] for i in range(4)])
    assert np.array_equal(batch["image"].numpy(), want)
    assert np.array_equal(center_crop(batch["image"], 32).numpy(),
                          want[:, 4:36, 4:36])
