"""PyTorch port, hub and shard data: data/iterable.py and create_dataset's
wds / hfds / tfds names against the JAX package's lemevit_tpu/data/
iterable.py. WebDatasetFolder on tar shards the test writes; HFDataset on
the `datasets` package's local ``imagefolder`` loader, with the hub off
and every outside connection refused in the test process; TFDSDataset and
HFDataset without their libraries raise JAX's ImportError."""
import io
import pickle
import socket
import sys
import tarfile

import numpy as np
import pytest
from PIL import Image

from lemevit_tpu.data import create_dataset as jax_create_dataset
from lemevit_tpu.data import iterable as JI
from lemevit_tpu.data.transforms import build_eval_transform as jax_eval
from lemevit_tpu_torch.data import datasets as D
from lemevit_tpu_torch.data import iterable as I
from lemevit_tpu_torch.data import transforms as T


def picture(seed, fmt):
    rs = np.random.RandomState(seed)
    h, w = (int(v) for v in rs.randint(20, 40, 2))
    img = Image.fromarray(rs.randint(0, 256, (h, w, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, fmt)
    return buf.getvalue()


def add(tf, name, payload):
    info = tarfile.TarInfo(name)
    info.size = len(payload)
    tf.addfile(info, io.BytesIO(payload))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """<root>/train/shard-000{0,1}.tar: keys with a PNG or JPEG and a .cls,
    one image without a label, one label without an image, a directory."""
    root = tmp_path_factory.mktemp("wds")
    (root / "train").mkdir()
    for s in range(2):
        with tarfile.open(root / "train" / f"shard-{s:04d}.tar", "w") as tf:
            tf.addfile(tarfile.TarInfo("sub/"))
            for j in range(4):
                key = f"s{s}_{3 - j:03d}"  # written out of key order
                fmt = "PNG" if j % 2 else "JPEG"
                add(tf, f"{key}.{fmt.lower()}", picture(10 * s + j, fmt))
                if (s, j) != (1, 2):
                    add(tf, f"{key}.cls", str(4 * s + j).encode())
            add(tf, "orphan.cls", b"9")
    return root


def test_webdataset_folder_against_jax(shards):
    got = I.WebDatasetFolder(str(shards / "train"))
    want = JI.WebDatasetFolder(str(shards / "train"))
    assert len(got) == len(want) == 8 and got.index == want.index
    assert [lab for *_, lab in got.index].count(-1) == 1
    for i in range(len(got)):
        (a, la), (b, lb) = got[i], want[i]
        assert np.array_equal(a, b) and la == lb and a.dtype == np.uint8
    # the JAX transform takes the image, the port's the image and an Rng
    tf_got = I.WebDatasetFolder(str(shards / "train"),
                                transform=T.build_eval_transform(16))
    tf_want = JI.WebDatasetFolder(str(shards / "train"),
                                  transform=jax_eval(16))
    for i in (0, 5, 7):
        img, lab = tf_got.get(i, T.Rng.from_seed(i))
        assert np.array_equal(img, tf_want[i][0]) and lab == tf_want[i][1]
        assert img.shape == (16, 16, 3)
    tf_got.close()


def test_webdataset_folder_pickles_without_handles(shards):
    ds = I.WebDatasetFolder(str(shards / "train" / "*.tar"))
    img, label = ds[6]  # opens the second shard
    assert ds._fds
    again = pickle.loads(pickle.dumps(ds))
    assert again._fds == {}
    img2, label2 = again[6]
    assert np.array_equal(img, img2) and label == label2
    ds.close()
    again.close()


@pytest.fixture(scope="module")
def many_shards(tmp_path_factory):
    """Three shards of 24 JPEGs and PNGs each, of sides 20-60, labelled
    with their sample's index."""
    root = tmp_path_factory.mktemp("wds_many")
    k = 0
    for s in range(3):
        with tarfile.open(root / f"shard-{s:04d}.tar", "w") as tf:
            for j in range(24):
                rs = np.random.RandomState(100 + k)
                h, w = (int(v) for v in rs.randint(20, 61, 2))
                fmt = "PNG" if k % 3 == 0 else "JPEG"
                buf = io.BytesIO()
                Image.fromarray(rs.randint(0, 256, (h, w, 3), np.uint8)).save(
                    buf, fmt)
                add(tf, f"k{k:03d}.{fmt.lower()}", buf.getvalue())
                add(tf, f"k{k:03d}.cls", str(k).encode())
                k += 1
    return root


def test_webdataset_folder_through_four_loader_threads(many_shards):
    """The loader's 4 producer threads read the shards of one dataset at
    once: every batch is what one thread reads alone, sample by sample."""
    from lemevit_tpu_torch.data.loader import create_loader
    ds = I.WebDatasetFolder(str(many_shards),
                            transform=T.build_eval_transform(24))
    alone = [ds.get(i, T.Rng.from_seed(i)) for i in range(len(ds))]
    ds.close()
    for _ in range(3):
        batches = list(create_loader(ds, 4, is_training=False,
                                     num_threads=4))
        images = np.concatenate([b["image"].numpy() for b in batches])
        labels = np.concatenate([b["label"].numpy() for b in batches])
        assert labels.tolist() == list(range(len(ds))) == [
            lab for _, lab in alone]
        for i, (img, _) in enumerate(alone):
            assert np.array_equal(images[i], img), i
    ds.close()


def test_webdataset_folder_raw_reads_in_threads(many_shards):
    """Eight threads reading every sample's image many times over, in
    different orders, get the single-thread bytes each time."""
    import threading
    ds = I.WebDatasetFolder(str(many_shards))
    alone = [ds[i][0] for i in range(len(ds))]
    bad = []

    def run(t):
        order = np.random.RandomState(t).permutation(len(ds))
        for _ in range(4):
            for i in order:
                try:
                    ok = np.array_equal(ds._image(int(i))[0], alone[i])
                except Exception as e:  # bytes of another member
                    ok = False, e
                if ok is not True:
                    bad.append((int(i), ok))

    threads = [threading.Thread(target=run, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    ds.close()
    assert bad == []


@pytest.mark.parametrize("name,kwargs", [
    ("wds", {"split": "train"}),
    ("wds/{root}/train/*.tar", {}),
    ("wds", {"split": "x", "shards": "{root}/train/shard-0001.tar"})],
    ids=["root-split", "glob", "shards"])
def test_create_dataset_wds_names(shards, name, kwargs):
    fill = {k: v.format(root=shards) for k, v in kwargs.items()}
    root = "" if name.startswith("wds/") else str(shards)
    name = name.format(root=shards)
    got = D.create_dataset(name, root, **fill)
    want = jax_create_dataset(name, root, **fill)
    assert type(got).__name__ == "WebDatasetFolder"
    assert got.index == want.index and got.paths == want.paths


def test_create_dataset_wds_without_shards_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no .tar shards"):
        D.create_dataset("wds", str(tmp_path), split="train")


@pytest.fixture
def offline(monkeypatch, tmp_path):
    """No outside host: the hub's offline switches on, its caches under
    tmp_path, and every socket connection or name lookup that is not
    local refused before it leaves the process."""
    for var in ("HF_HUB_OFFLINE", "HF_DATASETS_OFFLINE"):
        monkeypatch.setenv(var, "1")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("HF_DATASETS_CACHE", str(tmp_path / "hf" / "ds"))
    local = ("localhost", "127.0.0.1", "::1", None, "")

    def refuse(host):
        if host not in local and not str(host).startswith("/"):
            raise OSError(f"outside connection to {host!r} refused")

    real_connect, real_lookup = socket.socket.connect, socket.getaddrinfo

    def connect(sock, address):
        refuse(address[0] if isinstance(address, tuple) else None)
        return real_connect(sock, address)

    def lookup(host, *args, **kwargs):
        refuse(host)
        return real_lookup(host, *args, **kwargs)

    monkeypatch.setattr(socket.socket, "connect", connect)
    monkeypatch.setattr(socket, "getaddrinfo", lookup)
    datasets = pytest.importorskip("datasets")
    monkeypatch.setattr(datasets.config, "HF_HUB_OFFLINE", True,
                        raising=False)
    monkeypatch.setattr(datasets.config, "HF_DATASETS_OFFLINE", True,
                        raising=False)
    return tmp_path


def test_hf_dataset_against_jax_on_a_local_imagefolder(offline):
    root = offline / "imgs"
    for c in ("cat", "dog"):
        (root / "train" / c).mkdir(parents=True)
        for i in range(3):
            (root / "train" / c / f"{i}.png").write_bytes(
                picture(i + (10 if c == "dog" else 0), "PNG"))
    kw = dict(data_dir=str(root), cache_dir=str(offline / "cache"))
    got = D.create_dataset("hfds/imagefolder", split="train", **kw)
    want = JI.HFDataset("imagefolder", split="train", **kw)
    assert type(got).__name__ == "HFDataset" and len(got) == len(want) == 6
    labels = []
    for i in range(len(got)):
        (a, la), (b, lb) = got[i], want[i]
        assert np.array_equal(a, b) and la == lb
        labels.append(la)
    assert sorted(labels) == [0, 0, 0, 1, 1, 1]
    tf = I.HFDataset("imagefolder", split="train",
                     transform=T.build_eval_transform(16), **kw)
    img, _ = tf.get(2, T.Rng.from_seed(2))
    assert np.array_equal(img, T.build_eval_transform(16)(
        Image.fromarray(got[2][0])))


@pytest.mark.parametrize("name,package", [("hfds/x", "datasets"),
                                          ("tfds/x", "tensorflow_datasets")])
def test_hub_names_without_their_library_raise(monkeypatch, name, package):
    monkeypatch.setitem(sys.modules, package, None)  # import fails
    for create in (D.create_dataset, jax_create_dataset):
        with pytest.raises(ImportError, match=f"`{package}` package"):
            create(name, "", split="train")


def test_tfds_reads_rows_through_data_source(monkeypatch):
    """A stand-in tensorflow_datasets: rows are arrays, labels ints."""
    rows = [{"image": np.full((6, 5, 3), 40 * i, np.uint8), "label": i}
            for i in range(3)]

    class Module:
        @staticmethod
        def data_source(name, split, data_dir):
            assert (name, split, data_dir) == ("mnistish", "test", "/d")
            return rows

    monkeypatch.setitem(sys.modules, "tensorflow_datasets", Module)
    got = D.create_dataset("tfds/mnistish", "/d", split="test")
    want = jax_create_dataset("tfds/mnistish", "/d", split="test")
    assert len(got) == len(want) == 3
    for i in range(3):
        assert np.array_equal(got[i][0], want[i][0])
        assert got[i][1] == want[i][1] == i
    tf = D.create_dataset("tfds/mnistish", "/d", split="test",
                          transform=T.build_eval_transform(4))
    img, _ = tf.get(1, T.Rng.from_seed(0))
    assert img.shape == (4, 4, 3) and (img == 40).all()
