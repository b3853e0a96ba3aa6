"""PyTorch port, the classification CLIs on real images: cli.validate on a
test-written image folder and a UCM manifest tree against the JAX package's
cli.validate (lemevit_micro, 32 px, fp32, a ragged last batch, one
reference-named checkpoint loaded by both; loss within 2e-4, top-1, top-5
and the count equal), ReaL labels in both JSON forms, a zip read as the
folder, cli.train on an image folder that resumes where it stopped, and
the options that are not ported raising."""
import csv
import json
import os
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from lemevit_tpu.cli import validate as jax_validate
from lemevit_tpu.data import create_dataset as jax_create_dataset
from lemevit_tpu_torch.cli import train as train_cli
from lemevit_tpu_torch.cli import validate
from lemevit_tpu_torch.models.registry import create_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC = 7  # the micro model's classes (JAX's top-5 needs at least 5)
CLASSES = ("c0", "c1", "c2", "c3", "c4")
VAL_PER_CLASS = 3  # 15 images: batches of 4, 4, 4 and 3


def write_image(path, seed):
    rs = np.random.RandomState(seed)
    h, w = (int(v) for v in rs.randint(28, 60, 2))
    small = rs.randint(0, 256, (h // 4, w // 4, 3), np.uint8)
    img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
    if seed % 7 == 3:
        img = img.convert("L")  # greyscale: decoded with convert("RGB")
    img.save(path)


def val_name(i):
    return f"ILSVRC2012_val_{i + 1:08d}.JPEG"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """root/{train,validation}/<class>/..., the validation images named as
    ImageNet's; a UCM tree of the same validation images; a zip of them
    with its map file; a reference-named checkpoint of lemevit_micro."""
    root = tmp_path_factory.mktemp("data")
    ucm = root / "ucm"
    (ucm / "all_img").mkdir(parents=True)
    k = 0
    valid = []
    for ci, c in enumerate(CLASSES):
        for split, n in (("train", 4), ("validation", VAL_PER_CLASS)):
            d = root / "folder" / split / c
            d.mkdir(parents=True)
            for i in range(n):
                name = val_name(k) if split == "validation" else f"{i}.jpg"
                write_image(d / name, k)
                if split == "validation":
                    write_image(ucm / "all_img" / name, k)
                    valid.append((f"{c}/{name}", name, ci))
                k += 1
    (ucm / "valid_labels_55.txt").write_text(
        "".join(f"{name} {ci}\n" for _, name, ci in valid))
    (root / "zip").mkdir()
    with zipfile.ZipFile(root / "zip" / "validation.zip", "w") as zf:
        for inner, _, _ in valid:
            zf.write(root / "folder" / "validation" / inner, inner)
    (root / "zip" / "validation_map.txt").write_text(
        "".join(f"{inner}\t{ci}\n" for inner, _, ci in valid))
    ckpt = root / "micro.pth"
    torch.save({"state_dict": create_model(
        "lemevit_micro", num_classes=NC, device="cpu", seed=3).state_dict()},
        ckpt)
    return {"root": root, "folder": str(root / "folder"), "ucm": str(ucm),
            "zip": str(root / "zip"), "ckpt": str(ckpt), "valid": valid}


def argv(data_dir, ckpt, *extra):
    return ["--model", "lemevit_micro", "--img-size", "32",
            "--batch-size", "4", "--num-classes", str(NC),
            "--data-dir", data_dir, "--checkpoint", ckpt, *extra]


def jax_argv(data_dir, ckpt, *extra):
    """The JAX CLI's arguments: no native decode (importing it runs make),
    and a stop at the last batch by --max-batches, because the JAX
    DevicePrefetcher can drop its end marker while its queue is full
    (lemevit_tpu/data/loader.py:250-254) and then waits for ever."""
    n_batches = -(-len(CLASSES) * VAL_PER_CLASS // 4)
    return argv(data_dir, ckpt, "--no-native-decode", "--max-batches",
                str(n_batches), *extra)


def real_labels(valid):
    """Every third image unlabelled (ReaL skips it), the others labelled
    with their class and, for some, the classes around it."""
    out = {}
    for k, (_, name, ci) in enumerate(valid):
        out[name] = [] if k % 3 == 0 else (
            [ci] if k % 3 == 1 else [ci, (ci + 1) % NC, (ci + 2) % NC])
    return out


def test_validate_folder_matches_jax(data, tmp_path):
    """A ragged last batch (15 images in batches of 4), greyscale images
    among them, and ReaL labels as a JSON object and as real.json's list."""
    labels = real_labels(data["valid"])
    as_dict, as_list = tmp_path / "real.json", tmp_path / "real_list.json"
    as_dict.write_text(json.dumps(labels))
    as_list.write_text(json.dumps([labels.get(val_name(i), [])
                                   for i in range(40)]))
    want = jax_validate.main(jax_argv(data["folder"], data["ckpt"],
                                      "--real-labels", str(as_dict)))
    got = validate.main(argv(data["folder"], data["ckpt"], "--device", "cpu",
                             "--real-labels", str(as_dict)))
    n = len(jax_create_dataset("imagefolder", data["folder"],
                               split="validation"))
    assert got["count"] == n == len(data["valid"])
    assert abs(got["loss"] - want["loss"]) <= 2e-4, (got, want)
    for key in ("top1", "top5", "real_top1"):
        assert got[key] == want[key], key
    # real.json's list form, keyed by ILSVRC2012_val_%08d.JPEG, and one
    # loader thread give the same
    again = validate.main(argv(data["folder"], data["ckpt"], "--device",
                               "cpu", "--workers", "1", "--real-labels",
                               str(as_list)))
    assert {k: again[k] for k in ("loss", "top1", "top5", "count",
                                  "real_top1")} == {
        k: got[k] for k in ("loss", "top1", "top5", "count", "real_top1")}


def test_validate_hands_back_each_images_logits(data):
    """validate(args, logits) appends each batch's logits, the ragged last
    one too: in the dataset's order, they give the result's loss and
    top-1."""
    args = validate.build_parser().parse_args(
        argv(data["folder"], data["ckpt"], "--device", "cpu"))
    logits = []
    got = validate.validate(args, logits)
    assert [t.shape[0] for t in logits] == [4, 4, 4, 3]
    out = torch.cat(logits)
    labels = torch.tensor([ci for _, _, ci in data["valid"]])
    loss = torch.nn.functional.cross_entropy(out, labels).item()
    assert abs(loss - got["loss"]) <= 1e-4, (loss, got)
    top1 = 100.0 * (out.argmax(-1) == labels).float().mean().item()
    assert abs(top1 - got["top1"]) <= 1e-3, (top1, got)


def test_validate_ucm_matches_jax_and_zip_matches_folder(data):
    """--dataset ucm reads valid_labels_55.txt against the JAX package;
    --dataset zipfolder reads <dir>/validation.zip with its map file and
    gives what the folder gives."""
    extra = ("--dataset", "ucm", "--split", "valid")
    want = jax_validate.main(jax_argv(data["ucm"], data["ckpt"], *extra))
    got = validate.main(argv(data["ucm"], data["ckpt"], "--device", "cpu",
                             *extra))
    assert got["count"] == len(data["valid"])
    assert abs(got["loss"] - want["loss"]) <= 2e-4, (got, want)
    assert (got["top1"], got["top5"]) == (want["top1"], want["top5"])
    keys = ("loss", "top1", "top5", "count")
    zipped = validate.main(argv(data["zip"], data["ckpt"], "--device", "cpu",
                                "--dataset", "zipfolder"))
    folder = validate.main(argv(data["folder"], data["ckpt"], "--device",
                                "cpu"))
    assert {k: zipped[k] for k in keys} == {k: folder[k] for k in keys}


def _train(data, out, epochs, *extra):
    return train_cli.main([
        "--dataset", "imagefolder", "--data-dir", data["folder"],
        "--config", os.path.join(REPO, "configs", "lemevit.yaml"),
        "--model", "lemevit_micro", "--img-size", "32", "--batch-size", "4",
        "--num-classes", str(NC), "--device", "cpu", "--epochs", str(epochs),
        "--steps-per-epoch", "2", "--warmup-epochs", "1",
        "--checkpoint-hist", "3", "--workers", "2", "--output", str(out),
        *extra])


def test_train_on_a_folder_resumes(data, tmp_path):
    """Two steps on the configs/lemevit.yaml recipe (RandAugment, hflip,
    random resized crop, mixup, erasing), then a run that auto-resumes for
    two more with its batches built in a spawned worker process (and no
    eval, which spawns workers of its own): the weights equal those of four
    steps in one run with loader threads."""
    res = _train(data, tmp_path / "a", 1)
    assert res["steps"] == 2 and np.isfinite(res["train_loss"])
    res = _train(data, tmp_path / "a", 2, "--worker-procs", "1",
                 "--eval-interval", "3")
    assert res["steps"] == 4
    straight = _train(data, tmp_path / "b", 2)
    assert straight["steps"] == 4
    with open(tmp_path / "a" / "lemevit_micro" / "summary.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert rows[0]["top1"] != "" and rows[1]["top1"] == ""
    a, b = (torch.load(tmp_path / d / "lemevit_micro" / "checkpoints"
                       / "checkpoint-4.pth", weights_only=False)
            for d in ("a", "b"))
    for k, v in b["state_dict"].items():
        assert torch.equal(a["state_dict"][k], v), k


@pytest.mark.parametrize("cli,extra,err,match", [
    (train_cli, ["--packed-data", "x"], NotImplementedError, "item 4"),
    (train_cli, ["--native-decode"], NotImplementedError, "item 4"),
    (train_cli, ["--aug-splits", "3"], NotImplementedError, "item 2"),
    (train_cli, [], FileNotFoundError, "--synthetic"),
    (validate, ["--native-decode"], NotImplementedError, "item 4"),
    (validate, [], FileNotFoundError, "--synthetic")])
def test_unported_options_and_missing_data_raise(tmp_path, cli, extra, err,
                                                 match):
    args = ["--model", "lemevit_micro", "--img-size", "32", "--device",
            "cpu", "--data-dir", str(tmp_path / "missing"), *extra]
    if cli is train_cli:
        args += ["--output", str(tmp_path / "out")]
    with pytest.raises(err, match=match):
        cli.main(args)
