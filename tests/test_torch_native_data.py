"""PyTorch port, the C++ decode plane: data/native_decode.py (its build,
its entry points, the RRC and centre boxes) and the native transforms of
data/transforms.py against the JAX package's lemevit_tpu/data.

Against JAX's library bit for bit where it loads in this worker (the tests
never build it: its make writes native/ and races the other workers), and
always against PIL at tests/test_native_data.py's limits (crop and resize:
mean < 3, p99 <= 12; DCT-scaled decodes mean < 4; PNG mean < 1.5; the
native centre crop within mean 6 of the PIL eval transform, a 4-pixel
border left out at 40 px)."""
import io
import os
import random
import threading
import zipfile

import numpy as np
import pytest
from PIL import Image

from lemevit_tpu.data import native_decode as JN
from lemevit_tpu.data import transforms as JT
from lemevit_tpu_torch.data import datasets as D
from lemevit_tpu_torch.data import native_decode as N
from lemevit_tpu_torch.data import transforms as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_native():
    """Whether the JAX package's library loads here, without building it."""
    return os.path.exists(JN._SO_PATH) and JN.available()


def smooth(w, h, seed=0, mode="RGB"):
    """A low-frequency picture: decode differences stay small, so the
    comparisons test the resampler, not JPEG ringing."""
    rs = np.random.default_rng(seed)
    small = rs.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3), np.uint8)
    return Image.fromarray(small).resize((w, h), Image.BILINEAR).convert(mode)


def encode(img, fmt="JPEG"):
    buf = io.BytesIO()
    img.save(buf, fmt, **({"quality": 95} if fmt == "JPEG" else {}))
    return buf.getvalue()


KINDS = {  # name -> (bytes, whether the library decodes them)
    "jpeg": (lambda: encode(smooth(321, 203, 1)), True),
    "png": (lambda: encode(smooth(300, 220, 2), "PNG"), True),
    "gray_jpeg": (lambda: encode(smooth(200, 150, 3, "L")), True),
    "rgba_png": (lambda: encode(smooth(64, 80, 4, "RGBA"), "PNG"), True),
    "cmyk_jpeg": (lambda: encode(smooth(120, 90, 5, "CMYK")), False),
    "bmp": (lambda: encode(smooth(100, 70, 6), "BMP"), False),
}


def pil_crop(data, box, out, flip=False):
    img = Image.open(io.BytesIO(data)).convert("RGB").resize(
        out, Image.BICUBIC,
        box=(box[0], box[1], box[0] + box[2], box[1] + box[3]))
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return np.asarray(img, np.uint8)


def diff(a, b):
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


def jax_seeded(seed, fn, *args):
    py, nps = random.getstate(), np.random.get_state()
    try:
        random.seed(seed)
        np.random.seed(seed)
        return fn(*args)
    finally:
        random.setstate(py)
        np.random.set_state(nps)


def test_library_builds_from_the_ports_copy():
    assert N.available() and N.build_error() is None
    N.require()
    so = N.library_path(N.SOURCE, N.BUILD_DIR)
    assert so.exists() and so.name.startswith("libleme_data_")
    pkg = os.path.join(REPO, "lemevit_tpu_torch")
    assert str(N.SOURCE).startswith(pkg) and str(so).startswith(
        os.path.join(pkg, "_build"))
    # the copy's code is the JAX source's, line for line past its header
    jax_src = open(os.path.join(REPO, "native", "leme_data.cpp")).read()
    ours = N.SOURCE.read_text()
    start = "#include <cstddef>"
    assert ours[ours.index(start):] == jax_src[jax_src.index(start):]


def test_concurrent_builds_share_one_library(tmp_path):
    """More build calls at once than cores: one compile under the lock, one
    library, no temporary file left behind."""
    out, errors = [], []

    def run():
        try:
            out.append(N.build(N.SOURCE, tmp_path))
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    threads = [threading.Thread(target=run)
               for _ in range((os.cpu_count() or 1) + 4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not errors and not any(th.is_alive() for th in threads)
    assert len(out) == len(threads) and len(set(out)) == 1
    assert out[0] == N.library_path(N.SOURCE, tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [out[0].name, "libleme_data.lock"])


def test_failed_build_raises_quoting_the_compiler(tmp_path, monkeypatch):
    src = tmp_path / "leme_data.cpp"
    src.write_text("#error broken on purpose\n")
    monkeypatch.setattr(N, "SOURCE", src)
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "build")
    assert not N.available()
    assert "broken on purpose" in N.build_error()
    with pytest.raises(RuntimeError, match="broken on purpose"):
        N.require()
    with pytest.raises(RuntimeError, match="did not build"):
        N.resolve(True)
    assert N.resolve(None) is False and N.resolve(False) is False
    data = KINDS["jpeg"][0]()
    assert N.jpeg_size(data) is None
    assert N.decode_crop(data, (0, 0, 10, 10), (8, 8)) is None
    assert not list((tmp_path / "build").glob("*.so"))


def test_resolve_default_follows_the_library():
    assert N.resolve(None) is True and N.resolve(None, auto=False) is False
    assert N.resolve(True) is True and N.resolve(False) is False


@pytest.mark.parametrize("kind", list(KINDS))
def test_image_size(kind, jax_native):
    data, _ = KINDS[kind]
    data = data()
    got = N.jpeg_size(data)
    if kind == "bmp":
        assert got is None
    else:  # CMYK headers read too; only their decode declines
        assert got == Image.open(io.BytesIO(data)).size
    if jax_native:
        assert got == JN.image_size(data)
    assert N.jpeg_size(b"not an image") is None
    assert N.jpeg_size(b"\xff\xd8\xff" + bytes(40)) is None


CROPS = [  # kind, box, out (w, h), flip, mean limit
    ("jpeg", (37.0, 22.0, 256.0, 180.0), (224, 224), False, 3.0),
    ("jpeg", (3.5, 7.25, 120.6, 99.3), (64, 48), True, 3.0),
    ("png", (15.0, 10.0, 256.0, 192.0), (128, 128), False, 1.5),
    ("gray_jpeg", (0.0, 0.0, 200.0, 150.0), (96, 96), True, 3.0),
    ("rgba_png", (0.0, 0.0, 64.0, 80.0), (32, 40), False, 3.0),
    ("big_jpeg", (64.0, 40.0, 1408.0, 1056.0), (224, 224), False, 4.0),
]


@pytest.mark.parametrize("kind,box,out,flip,limit", CROPS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CROPS)])
def test_decode_crop(kind, box, out, flip, limit, jax_native):
    """Against PIL's crop-and-resize always (the big JPEG through libjpeg's
    DCT scaling), against JAX's library bit for bit where it loads."""
    data = (encode(smooth(1600, 1200, 7)) if kind == "big_jpeg"
            else KINDS[kind][0]())
    got = N.decode_crop(data, box, out, hflip=flip)
    assert got.shape == (out[1], out[0], 3) and got.dtype == np.uint8
    d = diff(got, pil_crop(data, box, out, flip))
    assert d.mean() < limit, d.mean()
    if limit <= 3.0 and kind != "rgba_png":
        assert np.percentile(d, 99) <= 12, np.percentile(d, 99)
    if kind.endswith("gray_jpeg"):
        assert diff(got[..., 0], got[..., 1]).max() <= 1
    if jax_native:
        assert np.array_equal(got, JN.decode_crop(data, box, out, flip))
    unflipped = N.decode_crop(data, box, out, hflip=not flip)
    assert np.array_equal(got, unflipped[:, ::-1])


@pytest.mark.parametrize("data", [
    KINDS["cmyk_jpeg"][0](), KINDS["bmp"][0](), b"\xff\xd8\xff" + bytes(64),
    b"\x89PNG\r\n\x1a\n" + bytes(64), b"short"],
    ids=["cmyk", "bmp", "corrupt_jpeg", "corrupt_png", "short"])
def test_decode_crop_declines(data, jax_native):
    """None where the caller must fall back to PIL, as JAX's."""
    assert N.decode_crop(data, (0, 0, 32, 32), (16, 16)) is None
    if jax_native:
        assert JN.decode_crop(data, (0, 0, 32, 32), (16, 16)) is None


@pytest.mark.parametrize("seed,w,h,scale", [
    (0, 400, 300, (0.08, 1.0)), (1, 64, 640, (0.08, 1.0)),
    (7, 333, 333, (0.5, 1.0)), (12345, 50, 49, (0.9, 1.0)),
    (3, 2, 900, (0.08, 1.0))])  # no box fits: the centre square
def test_rrc_box_draws_as_jax(seed, w, h, scale):
    """The same box and the same draws consumed as JAX's rrc_box under
    random.seed(s), from a transforms.Rng of s."""
    rng = T.Rng.from_seed(seed)
    got = N.rrc_box(w, h, rng.py, scale=scale)
    want, after = jax_seeded(seed, lambda: (JN.rrc_box(w, h, scale=scale),
                                            random.random()))
    assert got == want and rng.py.random() == after
    for size, pct in ((224, 0.9), (32, 0.875), (48, 1.0)):
        assert N.center_box(w, h, size, pct) == JN.center_box(w, h, size,
                                                              pct)


@pytest.mark.parametrize("aa", ["rand-m9-mstd0.5-inc1", None])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("seed", [0, 5])
def test_native_train_transform(kind, seed, aa, jax_native):
    """JAX's bits under one seed where its library loads; the PIL train
    transform's crop within PIL's limits always (no aa; the same box and
    flip drawn); PIL's bits where the library declines before any draw."""
    data, decodes = KINDS[kind]
    data = data()
    tf = T.build_native_train_transform(48, auto_augment=aa)
    assert tf.wants_encoded
    got = tf(data, T.Rng.from_seed(seed))
    assert got.shape == (48, 48, 3) and got.dtype == np.uint8
    if jax_native:
        jtf = JT.build_native_train_transform(48, auto_augment=aa)
        assert np.array_equal(got, jax_seeded(seed, jtf, data))
    pil = T.build_train_transform(48, auto_augment=aa)(
        Image.open(io.BytesIO(data)).convert("RGB"), T.Rng.from_seed(seed))
    if kind == "bmp":
        assert np.array_equal(got, pil)
    elif decodes and aa is None:
        d = diff(got, pil)
        assert d.mean() < 3.0 and np.percentile(d, 99) <= 12, d.mean()
    # a PIL image goes through the PIL path
    again = tf(Image.open(io.BytesIO(data)).convert("RGB"),
               T.Rng.from_seed(seed))
    assert np.array_equal(again, pil)


@pytest.mark.parametrize("kind", list(KINDS))
def test_native_eval_transform(kind, jax_native):
    data, decodes = KINDS[kind]
    data = data()
    got = T.build_native_eval_transform(40, 0.9)(data)
    assert got.shape == (40, 40, 3)
    if jax_native:
        assert np.array_equal(
            got, JT.build_native_eval_transform(40, 0.9)(data))
    ref = T.build_eval_transform(40, 0.9)(
        Image.open(io.BytesIO(data)).convert("RGB"))
    if decodes:  # crop-then-resize against resize-then-crop
        assert diff(got, ref)[4:-4, 4:-4].mean() < 6.0
    else:
        assert np.array_equal(got, ref)


def test_without_the_library_the_native_transforms_are_pils(tmp_path,
                                                            monkeypatch):
    src = tmp_path / "leme_data.cpp"
    src.write_text("#error no library\n")
    monkeypatch.setattr(N, "SOURCE", src)
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path)
    data = KINDS["jpeg"][0]()
    img = Image.open(io.BytesIO(data)).convert("RGB")
    for seed in (0, 1, 2):
        got = T.build_native_train_transform(32)(data, T.Rng.from_seed(seed))
        want = T.build_train_transform(32)(img, T.Rng.from_seed(seed))
        assert np.array_equal(got, want)
    assert np.array_equal(T.build_native_eval_transform(32)(data),
                          T.build_eval_transform(32)(img))


def test_datasets_hand_the_bytes(tmp_path, jax_native):
    """A folder, a manifest and a zip hand their encoded bytes to a native
    transform with the sample's generators; JAX's folder gives the same."""
    for i, kind in enumerate(("jpeg", "png", "bmp")):
        (tmp_path / "f" / f"c{i}").mkdir(parents=True)
        ext = {"jpeg": "jpg"}.get(kind, kind)
        (tmp_path / "f" / f"c{i}" / f"x.{ext}").write_bytes(KINDS[kind][0]())
    tf = T.build_native_train_transform(32)
    ds = D.ImageFolderDataset(str(tmp_path / "f"), transform=tf)
    got = [ds.get(i, T.Rng.from_seed(i)) for i in range(3)]
    for i, (img, label) in enumerate(got):
        with open(ds.samples[i][0], "rb") as f:
            assert np.array_equal(img, tf(f.read(), T.Rng.from_seed(i)))
        assert label == i
    with zipfile.ZipFile(tmp_path / "v.zip", "w") as zf:
        for path, label in ds.samples:
            zf.write(path, os.path.relpath(path, tmp_path / "f"))
    (tmp_path / "map.txt").write_text("".join(
        f"{os.path.relpath(p, tmp_path / 'f')}\t{c}\n" for p, c in ds.samples))
    zipped = D.ZipImageFolder(str(tmp_path / "v.zip"),
                              str(tmp_path / "map.txt"), transform=tf)
    for i in range(3):
        img, label = zipped.get(i, T.Rng.from_seed(i))
        assert np.array_equal(img, got[i][0]) and label == i
    if jax_native:
        from lemevit_tpu.data.datasets import ImageFolderDataset
        jds = ImageFolderDataset(str(tmp_path / "f"),
                                 transform=JT.build_native_train_transform(32))
        for i in range(3):
            img, label = jax_seeded(i, jds.__getitem__, i)
            assert np.array_equal(img, got[i][0]) and label == i


def test_decodes_in_threads_as_alone():
    """Four threads decoding at once (the GIL released in the library) give
    what one thread gives."""
    data = encode(smooth(640, 480, 11))
    boxes = [(float(i), float(2 * i), 300.0 + i, 200.0) for i in range(16)]
    alone = [N.decode_crop(data, b, (96, 96)) for b in boxes]
    out = [None] * len(boxes)

    def run(k):
        for i in range(k, len(boxes), 4):
            out[i] = N.decode_crop(data, boxes[i], (96, 96))

    threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert all(np.array_equal(a, b) for a, b in zip(alone, out))
