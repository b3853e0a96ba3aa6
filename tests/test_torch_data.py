"""PyTorch port, classification data plane: data/transforms.py,
data/datasets.py, data/loader.py and data/spawn.py against the JAX package's
lemevit_tpu/data on images the tests write with PIL.

The JAX transforms draw from the module-level ``random`` and ``np.random``;
the port's take a transforms.Rng. Seeding both globals with s before a JAX
call and handing the port Rng.from_seed(s) must give the same bits."""
import json
import os
import random
import sys
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from lemevit_tpu.data import datasets as JD
from lemevit_tpu.data import loader as JL
from lemevit_tpu.data import transforms as JT
from lemevit_tpu_torch.data import datasets as D
from lemevit_tpu_torch.data import loader as L
from lemevit_tpu_torch.data import spawn as S
from lemevit_tpu_torch.data import transforms as T

SEEDS = (0, 1, 7, 12345)


def jax_seeded(seed, fn, *args):
    """fn(*args) with random and np.random seeded by ``seed``; the global
    generators' states are restored after."""
    py, nps = random.getstate(), np.random.get_state()
    try:
        random.seed(seed)
        np.random.seed(seed)
        return fn(*args)
    finally:
        random.setstate(py)
        np.random.set_state(nps)


def arr(img):
    return np.asarray(img)


def picture(h, w, seed=0, mode="RGB"):
    """A smooth random picture (upsampled noise, so that the ops' outputs
    vary across the image) in PIL ``mode``."""
    rs = np.random.RandomState(seed)
    small = rs.randint(0, 256, (max(2, h // 4), max(2, w // 4), 3), np.uint8)
    img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
    if mode == "P":
        return img.convert("P", palette=Image.ADAPTIVE, colors=32)
    return img.convert(mode)


def write_folder(root, classes=("a", "b", "c"), per_class=3, seed=0,
                 ext=".jpg"):
    """root/<class>/<i><ext> pictures of mixed sizes."""
    rs = np.random.RandomState(seed)
    for ci, c in enumerate(classes):
        os.makedirs(os.path.join(root, c), exist_ok=True)
        for i in range(per_class):
            h, w = (int(v) for v in rs.randint(24, 56, 2))
            picture(h, w, seed=100 * ci + i).save(
                os.path.join(root, c, f"{i}{ext}"))


# ------------------------------------------------------------- transforms


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "P"])
@pytest.mark.parametrize("crop_pct", [0.875, 0.9, 1.0])
def test_eval_transform_bit_for_bit(tmp_path, mode, crop_pct):
    """Decode (convert to RGB) and centre crop, over sizes and PIL modes."""
    jt, tt = JT.build_eval_transform(24, crop_pct), T.build_eval_transform(
        24, crop_pct)
    for k, (h, w) in enumerate([(37, 53), (64, 48), (24, 24), (31, 90)]):
        path = str(tmp_path / f"{k}.png")
        picture(h, w, seed=k, mode=mode).save(path)
        want = jt(JD._pil_open(path))
        got = tt(D._pil_open(path))
        assert got.shape == (24, 24, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", range(15), ids=lambda i: f"op{i}")
def test_ra_op_bit_for_bit(op):
    """Each RandAugment op at magnitudes 0, 5, 9 and 10, under seeds that
    draw both signs."""
    assert len(T.RA_OPS) == len(JT.RA_OPS) == 15
    img = picture(40, 52, seed=op)
    for mag in (0, 5, 9, 10):
        for s in SEEDS:
            want = jax_seeded(s, JT.RA_OPS[op], img, mag)
            got = T.RA_OPS[op](img, mag, T.Rng.from_seed(s))
            assert got.size == want.size and got.mode == want.mode
            np.testing.assert_array_equal(arr(got), arr(want))


def test_augmix_ops_are_jax_ops():
    """AUGMIX_OPS picks the same nine ops, in JAX's order."""
    img = picture(36, 36, seed=3)
    assert len(T.AUGMIX_OPS) == len(JT.AUGMIX_OPS) == 9
    for jop, top in zip(JT.AUGMIX_OPS, T.AUGMIX_OPS):
        for s in SEEDS[:2]:
            np.testing.assert_array_equal(
                arr(top(img, 9, T.Rng.from_seed(s))),
                arr(jax_seeded(s, jop, img, 9)))


@pytest.mark.parametrize("kw", [dict(num_ops=2, magnitude=9, mag_std=0.5),
                                dict(num_ops=3, magnitude=7, mag_std=0.0)],
                         ids=["m9-mstd0.5", "m7-n3"])
def test_rand_augment_bit_for_bit(kw):
    img = picture(48, 40, seed=5)
    j, t = JT.RandAugment(**kw), T.RandAugment(**kw)
    for s in range(12):
        np.testing.assert_array_equal(arr(t(img, T.Rng.from_seed(s))),
                                      arr(jax_seeded(s, j, img)))


@pytest.mark.parametrize("kw", [dict(magnitude=3, width=3, depth=-1),
                                dict(magnitude=5, width=2, depth=2)],
                         ids=["m3-w3", "m5-w2-d2"])
def test_augmix_bit_for_bit(kw):
    """Dirichlet weights and Beta factor from np.random, then a depth and an
    op list per chain from random, in JAX's order."""
    img = picture(40, 40, seed=6)
    j, t = JT.AugMix(**kw), T.AugMix(**kw)
    for s in range(8):
        np.testing.assert_array_equal(arr(t(img, T.Rng.from_seed(s))),
                                      arr(jax_seeded(s, j, img)))


@pytest.mark.parametrize("scale", [(0.08, 1.0), (1.5, 2.0)],
                         ids=["tries", "fallback"])
def test_random_resized_crop_bit_for_bit(scale):
    """(1.5, 2.0) never fits, so every call takes the centre-crop
    fallback after its 10 tries."""
    img = picture(50, 70, seed=8)
    for s in SEEDS:
        rng = T.Rng.from_seed(s)
        got = T.random_resized_crop(img, 20, rng, scale=scale)
        want = jax_seeded(s, JT.random_resized_crop, img, 20, scale)
        np.testing.assert_array_equal(arr(got), arr(want))
        if scale[0] > 1:  # the fallback: the 10 tries drew 20 uniforms
            ref = random.Random(s)
            for _ in range(20):
                ref.random()
            assert rng.py.getstate() == ref.getstate()
            np.testing.assert_array_equal(
                arr(got), arr(T.center_crop_resize(img, 20, crop_pct=1.0)))


@pytest.mark.parametrize("aa,hflip", [("rand-m9-mstd0.5-inc1", 0.5),
                                      ("augmix-m3-w3", 0.5), ("", 1.0)])
def test_train_transform_bit_for_bit(aa, hflip):
    j = JT.build_train_transform(28, hflip=hflip, auto_augment=aa,
                                 scale=(0.3, 1.0))
    t = T.build_train_transform(28, hflip=hflip, auto_augment=aa,
                                scale=(0.3, 1.0))
    img = picture(45, 61, seed=9)
    for s in range(10):
        got = t(img, T.Rng.from_seed(s))
        assert got.shape == (28, 28, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_seeded(s, j, img))


@pytest.mark.parametrize("aa", ["rand-m9-mstd0.5-inc1", "rand-m7-n3",
                                "augmix-m3-w3", "augmix-m5-mstd0.5", ""])
def test_build_aug_policy(aa):
    j, t = JT.build_aug_policy(aa), T.build_aug_policy(aa)
    if not aa:
        assert j is None and t is None
        return
    assert type(t).__name__ == type(j).__name__
    assert vars(t) == vars(j)


def test_build_aug_policy_refuses_unknown():
    for aa in ("auto-v0", "trivial"):
        with pytest.raises(ValueError):
            JT.build_aug_policy(aa)
        with pytest.raises(ValueError, match="unknown auto_augment"):
            T.build_aug_policy(aa)


def test_sample_rng_is_a_function_of_seed_epoch_index():
    a, b = T.sample_rng(1, 2, 3), T.sample_rng(1, 2, 3)
    assert a.py.random() == b.py.random()
    assert a.np.randint(1 << 30) == b.np.randint(1 << 30)
    draws = {T.sample_rng(*k).py.random()
             for k in [(1, 2, 3), (1, 2, 4), (1, 3, 3), (2, 2, 3)]}
    assert len(draws) == 4


# ------------------------------------------------------------- datasets


def same_samples(jds, tds, ctx=None):
    """Same sample list, labels and decoded arrays (through each package's
    eval transform)."""
    assert [s for s in tds.samples] == [tuple(s) for s in jds.samples]
    assert len(tds) == len(jds)
    for i in range(len(jds)):
        (ja, jl), (ta, tl) = jds[i], tds[i]
        assert jl == tl
        np.testing.assert_array_equal(ta, ja)


def test_image_folder_matches_jax(tmp_path):
    write_folder(str(tmp_path / "train"), classes=("b", "a", "c"))
    write_folder(str(tmp_path / "validation"), per_class=2, ext=".png")
    (tmp_path / "train" / "a" / "notes.txt").write_text("not an image")
    for split in ("train", "validation"):
        jds = JD.create_dataset("imagefolder", str(tmp_path), split=split,
                                transform=JT.build_eval_transform(16))
        tds = D.create_dataset("imagefolder", str(tmp_path), split=split,
                               transform=T.build_eval_transform(16))
        assert tds.class_to_idx == jds.class_to_idx
        same_samples(jds, tds)
    # a root without the split directory is the folder itself
    jds = JD.create_dataset("folder", str(tmp_path / "train"))
    tds = D.create_dataset("folder", str(tmp_path / "train"))
    assert tds.samples == jds.samples and len(tds) == 9


@pytest.mark.parametrize("cache_mode,rank,world",
                         [("full", 0, 1), ("part", 1, 2), ("part", 0, 3)])
def test_image_folder_cache_modes(tmp_path, cache_mode, rank, world):
    write_folder(str(tmp_path), per_class=3)
    kw = dict(cache_mode=cache_mode, rank=rank, world_size=world)
    jds = JD.ImageFolderDataset(str(tmp_path),
                                transform=JT.build_eval_transform(16), **kw)
    tds = D.ImageFolderDataset(str(tmp_path),
                               transform=T.build_eval_transform(16), **kw)
    assert sorted(tds._bytes) == sorted(jds._bytes)
    assert all(tds._bytes[i] == jds._bytes[i] for i in jds._bytes)
    same_samples(jds, tds)
    uncached = D.ImageFolderDataset(str(tmp_path),
                                    transform=T.build_eval_transform(16))
    for i in range(len(tds)):
        np.testing.assert_array_equal(tds[i][0], uncached[i][0])


@pytest.mark.parametrize("name,manifests", [
    ("millionaid", ("train_labels.txt", "valid_labels.txt")),
    ("ucm", ("train_labels_55.txt", "valid_labels_55.txt")),
    ("aid", ("train_labels_55.txt", "valid_labels_55.txt")),
    ("nwpu_resisc45", ("train_labels_19.txt", "valid_labels_19.txt"))])
def test_manifest_datasets_match_jax(tmp_path, name, manifests):
    (tmp_path / "all_img" / "sub").mkdir(parents=True)
    names = [f"im{i}.jpg" for i in range(4)] + ["sub/x 1.png"]
    for i, n in enumerate(names):
        picture(30 + i, 40, seed=i).save(tmp_path / "all_img" / n)
    for mf, part in zip(manifests, (names[:3], names[3:])):
        with open(tmp_path / mf, "w") as f:
            for i, n in enumerate(part):
                f.write(f"{n} {i % 3}\n\n")
    for split in ("train", "valid"):
        jds = JD.create_dataset(name, str(tmp_path), split=split,
                                transform=JT.build_eval_transform(16))
        tds = D.create_dataset(name, str(tmp_path), split=split,
                               transform=T.build_eval_transform(16))
        same_samples(jds, tds)


def write_zip(tmp_path, sep="\t"):
    """split.zip with 4 images and a corrupt member, and split_map.txt."""
    zpath, ann = tmp_path / "train.zip", tmp_path / "train_map.txt"
    lines = []
    with zipfile.ZipFile(zpath, "w") as zf:
        for i in range(4):
            name = f"c{i % 2}/{i}.png"
            path = tmp_path / "tmp.png"
            picture(30, 34 + i, seed=i).save(path)
            zf.write(path, name)
            lines.append(f"{name}{sep}{i % 2}")
        zf.writestr("c1/bad.jpg", b"\xff\xd8 not a jpeg")
        lines.append(f"c1/bad.jpg{sep}1")
    ann.write_text("\n".join(lines) + "\n")
    return str(zpath), str(ann)


@pytest.mark.parametrize("sep", ["\t", " "])
def test_zip_folder_matches_jax(tmp_path, sep):
    """The corrupt member falls back to random pixels from the sample's
    generator (JAX: from np.random)."""
    zpath, ann = write_zip(tmp_path, sep)
    jds = JD.ZipImageFolder(zpath, ann, transform=JT.build_eval_transform(16))
    tds = D.create_dataset("zipfolder", str(tmp_path), split="train",
                           transform=T.build_eval_transform(16))
    assert tds.samples == jds.samples and len(tds) == 5
    for i in range(5):
        for s in SEEDS[:2]:
            got, lab = tds.get(i, T.Rng.from_seed(s))
            want, jlab = jax_seeded(s, jds.__getitem__, i)
            assert lab == jlab
            np.testing.assert_array_equal(got, want)
    # the fallback draws from the sample's generator
    a = tds.get(4, T.Rng.from_seed(1))[0]
    assert not np.array_equal(a, tds.get(4, T.Rng.from_seed(2))[0])
    np.testing.assert_array_equal(a, tds.get(4, T.Rng.from_seed(1))[0])
    tds.reader.close()


def test_zip_reader_paths(tmp_path):
    zpath, _ = write_zip(tmp_path)
    r = D.ZipReader()
    assert r.split_path(f"{zpath}@c0/0.png") == (zpath, "c0/0.png")
    with pytest.raises(ValueError, match="zip path"):
        r.split_path("no-at-sign.zip")
    assert r.read(f"{zpath}@c0/0.png") == JD.ZipReader.read(
        f"{zpath}@c0/0.png")
    assert r.handle(zpath) is r.handle(zpath)
    r.close()
    with pytest.raises(FileNotFoundError):
        D.ZipImageFolder(str(tmp_path / "missing.zip"), _)


# the hub and shard names (ROADMAP queue 1, item 4) are ported: without
# their library or their shards they raise as the JAX package does; the
# change-detection names (item 8) build a CDPairDataset from a written
# folder, the JAX package's samples (the cases keep their ids)
@pytest.mark.parametrize("name,err,match", [
    pytest.param("hfds/cifar10", ImportError, "`datasets` package",
                 id="hfds/cifar10-item 4"),
    pytest.param("tfds/imagenet2012", ImportError,
                 "`tensorflow_datasets` package",
                 id="tfds/imagenet2012-item 4"),
    pytest.param("wds", FileNotFoundError, "no .tar shards", id="wds-item 4"),
    pytest.param("wds/shards", FileNotFoundError, "no .tar shards",
                 id="wds/shards-item 4"),
    pytest.param("cdd", None, None, id="cdd-item 8"),
    pytest.param("levir", None, None, id="levir-item 8"),
    pytest.param("cd_pairs", None, None, id="cd_pairs-item 8")])
def test_names_that_wait_raise(tmp_path, monkeypatch, name, err, match):
    for package in ("datasets", "tensorflow_datasets"):
        monkeypatch.setitem(sys.modules, package, None)  # import fails
    if err is not None:
        with pytest.raises(err, match=match):
            D.create_dataset(name, str(tmp_path))
        return
    for i, sub in enumerate(("A", "B", "OUT")):
        os.makedirs(tmp_path / "val" / sub)
        for k in range(3):
            img = picture(20, 24, seed=10 * i + k)
            (img.convert("L") if sub == "OUT" else img).save(
                tmp_path / "val" / sub / f"{k}.png")
    ds = D.create_dataset(name, str(tmp_path), split="val")
    jds = JD.create_dataset(name, str(tmp_path), split="val")
    assert isinstance(ds, D.CDPairDataset) and len(ds) == len(jds) == 3
    assert ds.names == jds.names
    for k in range(3):
        (a, b), m = ds[k]
        (ja, jb), jm = jds[k]
        assert a.mode == b.mode == "RGB" and m.mode == "L"
        for x, y in ((a, ja), (b, jb), (m, jm)):
            np.testing.assert_array_equal(arr(x), arr(y))


def test_unknown_and_synthetic_names():
    with pytest.raises(ValueError, match="unknown dataset"):
        D.create_dataset("nosuch")
    for name in ("synthetic", "fake"):
        t = D.create_dataset(name, num_samples=3, image_size=8,
                             num_classes=5)
        j = JD.create_dataset(name, num_samples=3, image_size=8,
                              num_classes=5)
        for i in range(3):
            np.testing.assert_array_equal(t[i][0], j[i][0])
            assert t[i][1] == j[i][1]


# ------------------------------------------------------------- loader


class Indexed:
    """Sample i is (a 2x2 image of value i % 256, label i)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 2, 3), i % 256, np.uint8), i


@pytest.mark.parametrize("shuffle,drop_last,rank,world", [
    (True, True, 0, 1), (False, False, 0, 1), (True, False, 1, 3),
    (False, True, 2, 3)])
def test_loader_order_matches_jax(shuffle, drop_last, rank, world):
    ds = Indexed(23)
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=5, rank=rank,
              world_size=world, num_threads=2)
    jl, tl = JL.Loader(ds, 3, **kw), L.Loader(ds, 3, **kw)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        np.testing.assert_array_equal(tl._indices(), jl._indices())
        assert len(tl) == len(jl)
        jb, tb = list(jl), list(tl)
        assert [b["label"].tolist() for b in tb] == [
            b["label"].tolist() for b in jb]
        for b in tb:
            assert b["label"].dtype == torch.int64
            assert b["image"].dtype == torch.uint8


@pytest.fixture
def train_folder(tmp_path):
    write_folder(str(tmp_path / "train"), classes=("a", "b", "c", "d"),
                 per_class=5)
    return str(tmp_path)


def batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k


def test_threads_and_resume_give_the_same_batches(train_folder):
    """1 and 4 threads, and iter_batches(start), give identical augmented
    batches; another epoch or seed gives others."""
    ds = S.build_split_dataset("imagefolder", train_folder, "train",
                               img_size=16)

    def run(threads, seed=3, epoch=0, start=0):
        ld = L.create_loader(ds, 4, is_training=True, num_threads=threads,
                             seed=seed)
        ld.set_epoch(epoch)
        return list(ld.iter_batches(start))

    one = run(1)
    assert len(one) == 5 and one[0]["image"].shape == (4, 16, 16, 3)
    batches_equal(run(4), one)
    batches_equal(run(3, start=2), one[2:])
    assert not torch.equal(run(4, epoch=1)[0]["image"], one[0]["image"])
    assert not torch.equal(run(4, seed=4)[0]["image"], one[0]["image"])


def test_loader_raises_a_sample_failure_and_stops(tmp_path):
    class Failing(Indexed):
        def __getitem__(self, i):
            if i == 13:
                raise OSError("cannot read sample 13")
            return super().__getitem__(i)

    ld = L.create_loader(Failing(24), 4, num_threads=3)
    it = iter(ld)
    got = [next(it)["label"].tolist() for _ in range(3)]
    assert got == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    with pytest.raises(OSError, match="sample 13"):
        next(it)
    it = ld.iter_batches(0)
    next(it)
    it.close()  # stops the producers


def test_spawn_workers_match_threads(train_folder, tmp_path, monkeypatch):
    """Spawned workers build the dataset from its spec and give the thread
    path's batches, also from a start; a worker that imports jax fails (a
    stand-in jax package first on the workers' path raises on import)."""
    fake = tmp_path / "fakejax"
    (fake / "jax").mkdir(parents=True)
    (fake / "jax" / "__init__.py").write_text(
        "raise ImportError('a loader worker imported jax')\n")
    monkeypatch.syspath_prepend(str(fake))
    spec = S.DatasetSpec("lemevit_tpu_torch.data.spawn:build_split_dataset",
                         dict(dataset="imagefolder", data_dir=train_folder,
                              split="train", img_size=16))
    ds = spec.build()
    threads = L.create_loader(ds, 4, is_training=True, seed=2)
    procs = L.create_loader(ds, 4, is_training=True, seed=2, num_procs=2,
                            dataset_spec=spec)
    for ld in (threads, procs):
        ld.set_epoch(1)
    want = list(threads)
    batches_equal(list(procs), want)
    batches_equal(list(procs.iter_batches(3)), want[3:])
    bad = S.DatasetSpec("lemevit_tpu_torch.data.spawn:build_split_dataset",
                        dict(dataset="imagefolder", data_dir=str(tmp_path
                                                                 / "none"),
                             split="train"))
    with pytest.raises(RuntimeError, match="FileNotFoundError"):
        list(L.create_loader(ds, 4, num_procs=1, dataset_spec=bad))
    with pytest.raises(ValueError, match="dataset_spec"):
        L.Loader(ds, 4, num_procs=2)


@pytest.mark.parametrize("aug_splits", [0, 3], ids=["plain", "augsplits"])
def test_scale_reaches_threads_and_worker_procs(train_folder, aug_splits):
    """--scale 0.5 1.0 reaches the train transform through spec_for_split
    on both loaders: 2 threads and 2 spawned worker processes give the same
    batches, and both differ from the default scale's (the port keeps
    timm's behaviour; the JAX package's workers and AugMix splits drop
    --scale, ROADMAP queue 3)."""
    class Args:
        dataset, data_dir, img_size, hflip = ("imagefolder", train_folder,
                                               16, 0.5)
        aa, crop_pct, scale = "rand-m9-mstd0.5-inc1", 0.9, [0.5, 1.0]

    def batches(spec, procs):
        ld = L.create_loader(spec.build(), 4, is_training=True, seed=5,
                             num_threads=2, num_procs=procs,
                             dataset_spec=spec)
        return list(ld.iter_batches(3))

    spec = S.spec_for_split(Args, "train", True, aug_splits=aug_splits)
    assert spec.kwargs["scale"] == (0.5, 1.0)
    threads = batches(spec, 0)
    batches_equal(batches(spec, 2), threads)
    Args.scale = [0.08, 1.0]
    default = batches(S.spec_for_split(Args, "train", True,
                                       aug_splits=aug_splits), 0)
    assert not torch.equal(default[0]["image"], threads[0]["image"])


def test_spawn_worker_imports_no_jax():
    """The modules a spawned worker imports import no jax."""
    import subprocess
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import lemevit_tpu_torch.data.loader, "
            "lemevit_tpu_torch.data.spawn\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


@pytest.mark.parametrize("split,train", [("train", True),
                                         ("validation", False)])
def test_spec_for_split(train_folder, split, train):
    class Args:
        dataset, data_dir, img_size, hflip = ("imagefolder", train_folder,
                                               16, 0.5)
        aa, crop_pct, scale = "rand-m9-mstd0.5-inc1", 0.9, [0.08, 1.0]

    spec = S.spec_for_split(Args, split, train)
    assert spec.kwargs["train"] is train and spec.kwargs["split"] == split
    import pickle
    assert pickle.loads(pickle.dumps(spec)) == spec
    # packed: the split of a packed cache (none under "x"); native: the
    # native decode transforms, handed the encoded bytes
    with pytest.raises(FileNotFoundError, match="meta.json"):
        S.build_split_dataset("imagefolder", train_folder, split,
                              packed="x")
    native = S.build_split_dataset("imagefolder", train_folder, "train",
                                   img_size=16, train=train, native=True)
    assert native.transform.wants_encoded
    assert native[0][0].shape == (16, 16, 3)
    # aug splits: (S, H, W, 3) train samples
    img, _ = S.spec_for_split(Args, "train", True, aug_splits=3).build()[0]
    assert img.shape == (3, 16, 16, 3) and img.dtype == np.uint8


def test_device_prefetcher_propagates_worker_errors():
    """A failure in the batch iterator raises at the consumer, not as a
    clean end of the epoch."""
    def bad_iter():
        yield {"image": np.zeros((2, 4, 4, 3), np.uint8),
               "label": np.zeros((2,), np.int32)}
        raise RuntimeError("decode exploded")

    it = L.DevicePrefetcher(bad_iter(), lambda v: v, depth=2)
    next(it)
    with pytest.raises(RuntimeError, match="decode exploded"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_device_prefetcher_close_unblocks_worker():
    """close() retires the worker thread when the consumer stops early, and
    closes the iterator it read."""
    closed = []

    def many():
        try:
            for i in range(100):
                yield {"i": np.asarray([i])}
        finally:
            closed.append(True)

    it = L.DevicePrefetcher(many(), lambda v: v, depth=2)
    assert next(it)["i"].tolist() == [0]
    it.close()
    assert not it._t.is_alive()
    assert closed == [True]


def test_device_prefetcher_ends_when_the_queue_is_full():
    """The end of the iterator is passed on even while the queue is full
    (the consumer slower than the producer)."""
    import time
    it = L.DevicePrefetcher(iter([{"i": i} for i in range(3)]),
                            lambda v: v, depth=2)
    time.sleep(0.3)  # the producer fills the queue and waits
    assert [b["i"] for b in it] == [0, 1, 2]
    it.close()
    assert not it._t.is_alive()


def test_real_labels_forms(tmp_path):
    from lemevit_tpu_torch.cli.validate import load_real_labels
    (tmp_path / "d.json").write_text(json.dumps({"x.jpg": [1, 2]}))
    (tmp_path / "l.json").write_text(json.dumps([[3], [], [4, 5]]))
    assert load_real_labels(str(tmp_path / "d.json")) == {"x.jpg": [1, 2]}
    assert load_real_labels(str(tmp_path / "l.json")) == {
        "ILSVRC2012_val_00000001.JPEG": [3],
        "ILSVRC2012_val_00000002.JPEG": [],
        "ILSVRC2012_val_00000003.JPEG": [4, 5]}
