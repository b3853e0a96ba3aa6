"""Host-side image transforms (PIL / numpy) and device-side normalisation.
Counterpart of lemevit_tpu/data/transforms.py (the reference's timm stack:
RandomResizedCrop + hflip + RandAugment rand-m9-mstd0.5-inc1, bicubic; eval
centre crop at crop_pct 0.9) and of lemevit_tpu/data/mixup.py::normalize.

The host decodes, crops, flips and augments in uint8; the batch crosses to
the device as uint8 NHWC and is normalised there (``normalize``).

Explicit generators: where the JAX package draws from the module-level
``random`` and ``np.random``, every random callable here takes a ``Rng``
(one ``random.Random``, one ``np.random.RandomState``) and makes the same
calls in the same order. So ``random.seed(s); np.random.seed(s)`` before a
JAX call and ``Rng.from_seed(s)`` handed to the port give the same bits.
The loader gives each sample its own ``sample_rng(seed, epoch, index)``.

The native transforms (``build_native_*``) take the encoded bytes
(``wants_encoded``) and decode, crop and flip them in C++
(data/native_decode.py), with the PIL path's draws in its order.
"""
from __future__ import annotations

import io
import math
import random
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from PIL import Image, ImageEnhance, ImageOps

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Rng(NamedTuple):
    """One sample's generators: ``py`` takes the draws the JAX package makes
    on ``random``, ``np`` those it makes on ``np.random``."""
    py: random.Random
    np: np.random.RandomState

    @classmethod
    def from_seed(cls, seed: int) -> "Rng":
        return cls(random.Random(seed), np.random.RandomState(seed))


def sample_rng(seed: int, epoch: int, index: int) -> Rng:
    """The generators of sample ``index`` in ``epoch`` of a run seeded
    ``seed``: a function of the three alone, so any thread count, worker
    process or resumed epoch draws the same."""
    a, b = np.random.SeedSequence([seed, epoch, index]).generate_state(2)
    return Rng(random.Random(int(a)), np.random.RandomState(int(b)))


def normalize(images_u8: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 NHWC -> normalised float NHWC, on the images' device."""
    x = images_u8.to(dtype) / 255.0
    mean = torch.tensor(mean, dtype=dtype, device=images_u8.device)
    std = torch.tensor(std, dtype=dtype, device=images_u8.device)
    return (x - mean) / std


# ------------------------------------------------------------- geometric

def random_resized_crop(img: Image.Image, size: int, rng: Rng,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)
                        ) -> Image.Image:
    """timm's RandomResizedCrop, bicubic: 10 tries at an area and aspect
    drawn from ``scale`` and ``ratio``, then a centre crop."""
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.py.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.py.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = rng.py.randint(0, w - cw)
            y0 = rng.py.randint(0, h - ch)
            return img.resize((size, size), Image.BICUBIC,
                              box=(x0, y0, x0 + cw, y0 + ch))
    return center_crop_resize(img, size, crop_pct=1.0)


def center_crop_resize(img: Image.Image, size: int,
                       crop_pct: float = 0.9) -> Image.Image:
    """Resize the short side to floor(size / crop_pct), bicubic, and take
    the centre size x size."""
    w, h = img.size
    scale_size = int(math.floor(size / crop_pct))
    short = min(w, h)
    nw, nh = (int(round(w * scale_size / short)),
              int(round(h * scale_size / short)))
    img = img.resize((nw, nh), Image.BICUBIC)
    x0 = (nw - size) // 2
    y0 = (nh - size) // 2
    return img.crop((x0, y0, x0 + size, y0 + size))


# ------------------------------------------------------------- randaugment
# Each op is op(img, magnitude, rng); the signed ops draw their sign first.

def _sign(rng: Rng) -> int:
    return 1 if rng.py.random() < 0.5 else -1


def _autocontrast(img, _, rng):
    return ImageOps.autocontrast(img)


def _equalize(img, _, rng):
    return ImageOps.equalize(img)


def _invert(img, _, rng):
    return ImageOps.invert(img)


def _rotate(img, mag, rng):
    return img.rotate(mag / 9.0 * 30.0 * _sign(rng), resample=Image.BICUBIC)


def _posterize(img, mag, rng):
    return ImageOps.posterize(img, max(1, 8 - int(mag / 9.0 * 4)))


def _solarize(img, mag, rng):
    return ImageOps.solarize(img, max(0, int(256 - mag / 9.0 * 256)))


def _solarize_add(img, mag, rng):
    add = int(mag / 9.0 * 110)
    arr = np.asarray(img).astype(np.int16)
    arr = np.where(arr < 128, np.clip(arr + add, 0, 255), arr)
    return Image.fromarray(arr.astype(np.uint8))


def _enhance(cls):
    def fn(img, mag, rng):
        # "inc1": the magnitude moves the factor away from 1 either way
        v = 1.0 + (mag / 9.0) * 0.9 * _sign(rng)
        return cls(img).enhance(max(0.1, v))
    return fn


def _shear(axis):
    def fn(img, mag, rng):
        v = mag / 9.0 * 0.3 * _sign(rng)
        mat = (1, v, 0, 0, 1, 0) if axis == "x" else (1, 0, 0, v, 1, 0)
        return img.transform(img.size, Image.AFFINE, mat,
                             resample=Image.BICUBIC)
    return fn


def _translate(axis):
    def fn(img, mag, rng):
        frac = mag / 9.0 * 0.45 * _sign(rng)
        px = int(frac * (img.size[0] if axis == "x" else img.size[1]))
        mat = (1, 0, px, 0, 1, 0) if axis == "x" else (1, 0, 0, 0, 1, px)
        return img.transform(img.size, Image.AFFINE, mat,
                             resample=Image.BICUBIC)
    return fn


RA_OPS = [
    _autocontrast, _equalize, _invert, _rotate, _posterize, _solarize,
    _solarize_add,
    _enhance(ImageEnhance.Color), _enhance(ImageEnhance.Contrast),
    _enhance(ImageEnhance.Brightness), _enhance(ImageEnhance.Sharpness),
    _shear("x"), _shear("y"), _translate("x"), _translate("y"),
]

# AugMix's op set (Hendrycks et al.): geometric and histogram ops only
AUGMIX_OPS = [RA_OPS[i] for i in (0, 1, 3, 4, 5, 11, 12, 13, 14)]


class AugMix:
    """Mix ``width`` chains of random ops with Dirichlet weights, then blend
    with the source by a Beta factor (timm's 'augmix-m{M}-w{W}-d{D}')."""

    def __init__(self, magnitude: float = 3.0, width: int = 3,
                 depth: int = -1, alpha: float = 1.0):
        self.magnitude = magnitude
        self.width = width
        self.depth = depth
        self.alpha = alpha

    def __call__(self, img: Image.Image, rng: Rng) -> Image.Image:
        ws = rng.np.dirichlet([self.alpha] * self.width)
        m = float(rng.np.beta(self.alpha, self.alpha))
        base = np.asarray(img, np.float32)
        mixed = np.zeros_like(base)
        for i in range(self.width):
            depth = self.depth if self.depth > 0 else rng.py.randint(1, 3)
            aug = img
            for op in rng.py.choices(AUGMIX_OPS, k=depth):
                aug = op(aug, self.magnitude, rng)
            mixed += ws[i] * np.asarray(aug, np.float32)
        out = (1 - m) * base + m * mixed
        return Image.fromarray(np.clip(out, 0, 255).astype(np.uint8))


class RandAugment:
    """rand-m{M}-mstd{S}-inc1: ``num_ops`` random ops at a gaussian-jittered
    magnitude, clipped to [0, 10]."""

    def __init__(self, num_ops: int = 2, magnitude: float = 9.0,
                 mag_std: float = 0.5):
        self.num_ops = num_ops
        self.magnitude = magnitude
        self.mag_std = mag_std

    def __call__(self, img: Image.Image, rng: Rng) -> Image.Image:
        for op in rng.py.choices(RA_OPS, k=self.num_ops):
            mag = self.magnitude
            if self.mag_std > 0:
                mag = rng.py.gauss(mag, self.mag_std)
            img = op(img, min(max(mag, 0.0), 10.0), rng)
        return img


def build_aug_policy(auto_augment: Optional[str]):
    """A timm-style aa string -> a (img, rng) -> img callable:
    'rand-m9-mstd0.5-inc1' -> RandAugment, 'augmix-m3-w3[-dD]' -> AugMix,
    None / '' -> None; anything else raises ValueError."""
    if not auto_augment:
        return None
    if auto_augment.startswith("augmix"):
        mag, width, depth = 3.0, 3, -1
        for tok in auto_augment.split("-")[1:]:
            if tok.startswith("mstd"):
                pass  # timm's form; AugMix has no magnitude jitter
            elif tok.startswith("m"):
                mag = float(tok[1:])
            elif tok.startswith("w"):
                width = int(tok[1:])
            elif tok.startswith("d"):
                depth = int(tok[1:])
        return AugMix(magnitude=mag, width=width, depth=depth)
    if auto_augment.startswith("rand"):
        mag, mag_std, num_ops = 9.0, 0.5, 2
        for tok in auto_augment.split("-")[1:]:
            if tok.startswith("mstd"):
                mag_std = float(tok[4:])
            elif tok.startswith("m"):
                mag = float(tok[1:])
            elif tok.startswith("n"):
                num_ops = int(tok[1:])
        return RandAugment(num_ops=num_ops, magnitude=mag, mag_std=mag_std)
    raise ValueError(f"unknown auto_augment policy {auto_augment!r}")


# ------------------------------------------------------------- pipelines

def build_train_transform(img_size: int = 224, hflip: float = 0.5,
                          auto_augment: Optional[str] = "rand-m9-mstd0.5-inc1",
                          scale=(0.08, 1.0)) -> Callable:
    """(PIL image, rng) -> uint8 (img_size, img_size, 3): random resized
    crop, horizontal flip with probability ``hflip``, the aa policy."""
    ra = build_aug_policy(auto_augment)

    def transform(img: Image.Image, rng: Rng) -> np.ndarray:
        img = random_resized_crop(img, img_size, rng, scale=scale)
        if hflip > 0 and rng.py.random() < hflip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if ra is not None:
            img = ra(img, rng)
        return np.asarray(img, dtype=np.uint8)

    return transform


def build_augsplit_transform(img_size: int = 224, hflip: float = 0.5,
                             auto_augment: str = "augmix-m3-w3",
                             num_splits: int = 3,
                             scale=(0.08, 1.0)) -> Callable:
    """(PIL image, rng) -> uint8 (num_splits, img_size, img_size, 3), timm's
    AugMixDataset: one random resized crop and flip per sample, then split
    0 clean and splits 1.. each through the aa policy (AugMix for the JSD
    recipe), in the JAX package's order of draws."""
    aug = build_aug_policy(auto_augment)

    def transform(img: Image.Image, rng: Rng) -> np.ndarray:
        img = random_resized_crop(img, img_size, rng, scale=scale)
        if hflip > 0 and rng.py.random() < hflip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        views = [np.asarray(img, np.uint8)]
        for _ in range(num_splits - 1):
            views.append(np.asarray(aug(img, rng) if aug else img, np.uint8))
        return np.stack(views)

    return transform


def build_native_train_transform(img_size: int = 224, hflip: float = 0.5,
                                 auto_augment: Optional[str] =
                                 "rand-m9-mstd0.5-inc1",
                                 scale=(0.08, 1.0)) -> Callable:
    """(encoded bytes or PIL image, rng) -> uint8 (img_size, img_size, 3):
    decode, random resized crop and flip in C++ with the GIL released (the
    box from ``rng.py``, then the flip from ``rng.py.random()``), then the
    aa policy on the cropped image. Bytes the library cannot decode (other
    formats, CMYK, corrupt, no library) and PIL images go through
    build_train_transform."""
    from lemevit_tpu_torch.data import native_decode as nd

    ra = build_aug_policy(auto_augment)
    pil_path = build_train_transform(img_size, hflip, auto_augment, scale)

    def transform(data, rng: Rng) -> np.ndarray:
        if isinstance(data, (bytes, bytearray, memoryview)):
            data = bytes(data)
            size = nd.jpeg_size(data)
            if size is not None:
                box = nd.rrc_box(*size, rng.py, scale=scale)
                flip = hflip > 0 and rng.py.random() < hflip
                arr = nd.decode_crop(data, box, (img_size, img_size), flip)
                if arr is not None:
                    if ra is not None:
                        arr = np.asarray(ra(Image.fromarray(arr), rng),
                                         np.uint8)
                    return arr
            data = Image.open(io.BytesIO(data)).convert("RGB")
        return pil_path(data, rng)

    transform.wants_encoded = True
    return transform


def build_native_eval_transform(img_size: int = 224,
                                crop_pct: float = 0.9) -> Callable:
    """The native twin of build_eval_transform: the centre crop as one
    crop-then-resize in C++ (native_decode.center_box); draws nothing."""
    from lemevit_tpu_torch.data import native_decode as nd

    pil_path = build_eval_transform(img_size, crop_pct)

    def transform(data, rng: Optional[Rng] = None) -> np.ndarray:
        if isinstance(data, (bytes, bytearray, memoryview)):
            data = bytes(data)
            size = nd.jpeg_size(data)
            if size is not None:
                arr = nd.decode_crop(data,
                                     nd.center_box(*size, img_size, crop_pct),
                                     (img_size, img_size))
                if arr is not None:
                    return arr
            data = Image.open(io.BytesIO(data)).convert("RGB")
        return pil_path(data, rng)

    transform.wants_encoded = True
    return transform


def build_eval_transform(img_size: int = 224,
                         crop_pct: float = 0.9) -> Callable:
    """(PIL image, rng=None) -> uint8 (img_size, img_size, 3): the centre
    crop; draws nothing."""
    def transform(img: Image.Image, rng: Optional[Rng] = None) -> np.ndarray:
        return np.asarray(center_crop_resize(img, img_size, crop_pct),
                          dtype=np.uint8)

    return transform
