"""PyTorch port, the COCO data plane (data/coco.py) against the JAX
package's, exactly: polygon rasterization, column-major RLE decoding,
ann_to_mask, COCODataset item by item on a COCO folder the test writes
(images of five aspect ratios, polygon annotations, one uncompressed-RLE
annotation, one crowd annotation, sparse category ids, an image without
annotations), SyntheticInstanceSeg, instance_collate and paste_masks."""
import json

import numpy as np
import pytest

from lemevit_tpu.data import coco as J
from lemevit_tpu_torch.data import coco as P

CATS = [{"id": 3, "name": "cat"}, {"id": 9, "name": "dog"},
        {"id": 44, "name": "bottle"}, {"id": 90, "name": "toothbrush"}]
# (file, width, height) of the written images
IMAGES = [("a.jpg", 100, 60), ("b.png", 48, 90), ("c.jpg", 75, 75),
          ("d.png", 131, 37), ("e.jpg", 40, 52)]


def rand_rle(rs, h, w):
    """Uncompressed RLE counts of a random mask (column-major runs, 0s
    first) and the mask itself."""
    flat = np.zeros(h * w, bool)
    counts, pos, val = [], 0, False
    while pos < h * w:
        n = int(min(rs.randint(1, 40), h * w - pos))
        flat[pos:pos + n] = val
        counts.append(n)
        pos += n
        val = not val
    return counts, flat.reshape(w, h).T


def test_rasterize_polygons():
    rs = np.random.RandomState(0)
    for h, w in ((10, 12), (37, 53), (64, 64)):
        polys = [list(rs.uniform(-3, max(h, w) + 3, 2 * n))
                 for n in (3, 5, 8)] + [[1.0, 2.0, 3.0, 4.0]]  # < 3 points
        got = P.rasterize_polygons(polys, h, w)
        want = J.rasterize_polygons(polys, h, w)
        assert got.dtype == bool and got.shape == (h, w)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < h * w


def test_decode_rle_and_ann_to_mask():
    rs = np.random.RandomState(1)
    for h, w in ((2, 4), (13, 7), (40, 31)):
        counts, mask = rand_rle(rs, h, w)
        rle = {"counts": counts, "size": [h, w]}
        got = P.decode_rle(rle, h, w)
        np.testing.assert_array_equal(got, J.decode_rle(rle, h, w))
        np.testing.assert_array_equal(got, mask)
        np.testing.assert_array_equal(
            P.ann_to_mask({"segmentation": rle}, h, w), mask)
    poly = {"segmentation": [[2, 2, 8, 2, 8, 6, 2, 6]]}
    np.testing.assert_array_equal(P.ann_to_mask(poly, 10, 12),
                                  J.ann_to_mask(poly, 10, 12))
    assert not P.ann_to_mask({}, 5, 6).any()
    with pytest.raises(ValueError, match="compressed RLE"):
        P.decode_rle({"counts": "abc", "size": [2, 2]}, 2, 2)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """A COCO folder written from a seed: val2017/ images and
    annotations/instances_val2017.json. Returns (root, the written
    annotations)."""
    from PIL import Image
    root = tmp_path_factory.mktemp("coco")
    (root / "val2017").mkdir()
    (root / "annotations").mkdir()
    rs = np.random.RandomState(2)
    images, anns = [], []
    for i, (name, w, h) in enumerate(IMAGES):
        Image.fromarray(rs.randint(0, 256, (h, w, 3), np.uint8)).save(
            root / "val2017" / name)
        images.append({"id": 10 + 3 * i, "file_name": name, "width": w,
                       "height": h})
        if name == "e.jpg":
            continue  # no annotations
        for j in range(3):
            x0, y0 = rs.uniform(0, w * 0.5), rs.uniform(0, h * 0.5)
            bw, bh = rs.uniform(4, w * 0.5), rs.uniform(4, h * 0.5)
            poly = [x0, y0, x0 + bw, y0 + 0.2 * bh, x0 + 0.8 * bw, y0 + bh,
                    x0, y0 + 0.7 * bh]
            anns.append({"id": len(anns) + 1, "image_id": 10 + 3 * i,
                         "category_id": CATS[rs.randint(len(CATS))]["id"],
                         "iscrowd": 0, "bbox": [x0, y0, bw, bh],
                         "segmentation": [poly]})
    counts, _ = rand_rle(rs, 60, 100)
    anns.append({"id": len(anns) + 1, "image_id": 10, "category_id": 90,
                 "iscrowd": 0, "bbox": [5, 5, 50, 40],
                 "segmentation": {"counts": counts, "size": [60, 100]}})
    anns.append({"id": len(anns) + 1, "image_id": 13, "category_id": 44,
                 "iscrowd": 1, "bbox": [0, 0, 20, 20],
                 "segmentation": [[0, 0, 20, 0, 20, 20]]})
    ann = {"images": images, "categories": CATS[::-1], "annotations": anns}
    with open(root / "annotations" / "instances_val2017.json", "w") as f:
        json.dump(ann, f)
    return str(root), ann


def test_coco_dataset_items(coco_root):
    root, ann = coco_root
    got_ds = P.COCODataset(root, "val2017", img_size=64)
    want_ds = J.COCODataset(root, "val2017", img_size=64)
    assert len(got_ds) == len(want_ds) == len(IMAGES)
    assert got_ds.cat_to_label == {3: 0, 9: 1, 44: 2, 90: 3}
    assert got_ds.class_names == ["cat", "dog", "bottle", "toothbrush"]
    n_objects = 0
    for i in range(len(got_ds)):
        got, want = got_ds[i], want_ds[i]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        img, boxes, labels, masks = got
        info = got_ds.images[got_ds.ids[i]]
        written = [a for a in ann["annotations"]
                   if a["image_id"] == info["id"] and not a["iscrowd"]]
        assert len(boxes) == len(written)
        scale = 64 / max(info["width"], info["height"])
        nh = round(info["height"] * scale)
        nw = round(info["width"] * scale)
        assert not img[nh:].any() and not img[:, nw:].any()  # padding
        for a, b, lb, m in zip(written, boxes, labels, masks):
            x, y, bw, bh = a["bbox"]
            np.testing.assert_allclose(
                b, np.float32([x, y, x + bw, y + bh]) * scale, rtol=1e-6)
            assert lb == got_ds.cat_to_label[a["category_id"]]
            assert m[:nh, :nw].any() and not m[nh:].any()
        n_objects += len(boxes)
    assert n_objects == 3 * 4 + 1  # the crowd annotation is skipped


def test_synthetic_instance_seg():
    got, want = P.SyntheticInstanceSeg(6, 48, 4), J.SyntheticInstanceSeg(
        6, 48, 4)
    for i in range(6):
        for g, w in zip(got[i], want[i]):
            np.testing.assert_array_equal(g, w)


def test_instance_collate(coco_root):
    ds = P.COCODataset(coco_root[0], "val2017", img_size=64)
    samples = [ds[i] for i in range(len(ds))]
    for max_boxes in (2, 5):
        got = P.instance_collate(samples, max_boxes=max_boxes)
        want = J.instance_collate(samples, max_boxes=max_boxes)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        assert got["gt_labels"].dtype.is_floating_point is False
        assert got["gt_valid"].sum() == sum(min(len(s[1]), max_boxes)
                                            for s in samples)


def test_paste_masks():
    rs = np.random.RandomState(3)
    k, m, c = 12, 8, 3
    xy = rs.uniform(-10, 60, (k, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(-2, 40, (k, 2))],
                           1).astype(np.float32)
    probs = rs.uniform(0, 1, (k, m, m)).astype(np.float32)
    got = P.paste_masks(boxes, probs, (48, 56))
    np.testing.assert_array_equal(got, J.paste_masks(boxes, probs, (48, 56)))
    assert got.any()
    per_class = rs.uniform(0, 1, (k, m, m, c)).astype(np.float32)
    labels = rs.randint(0, c, k)
    got = P.paste_masks(boxes, per_class, (48, 56), labels=labels, thr=0.3)
    np.testing.assert_array_equal(got, J.paste_masks(
        boxes, per_class, (48, 56), labels=labels, thr=0.3))
