"""Train augmentation over the whole batch on its device; counterpart of
lemevit_tpu/data/device_aug.py.

With the packed cache (data/packed.py) the host streams fixed-size uint8
squares, and the random resized crop, the horizontal flip and RandAugment
(rand-m9-mstd0.5-inc1, configs/lemevit.yaml's aa) run here, in float32 on
the [0, 255] scale, as the JAX function computes them:

  - the crop: the first valid box of 10 (area, log-ratio) tries, else the
    whole square, at an integer offset; resampled with JAX's own
    ``scale_and_translate(method="cubic")`` (Keys' cubic, a = -0.5,
    antialiased when it shrinks): a row and a column weight matrix per
    image (``_weights``, jax/_src/image/scale.py::compute_weight_mat)
    applied as two batched products;
  - RandAugment: the stratified op assignment of ``_ra_layer_batch`` (a
    permutation, the batch split near-evenly over the 15 ops by
    ``balanced_split``, each geometric op's share over ``GEO_VARIANTS``'
    three quantised levels x two signs); rotate and shear as one bilinear
    ``F.grid_sample`` with a matrix per image (zero fill, PIL's half-pixel
    frame), translates as exact integer shifts, the ten elementwise ops
    (equalize from a stride-4 sample of each channel, its LUT indexed)
    each on its own slots.

Every random step is a draw and an apply. ``DeviceAug.draw(gen, b,
device)`` takes from the step's ``torch.Generator``, in this order: per
image 10 area and 10 log-ratio uniforms, 2 position uniforms and a flip
uniform; per RandAugment layer a permutation, gaussian-jittered magnitudes
and sign uniforms. ``DeviceAug.apply(images_u8, draws)`` is a pure
function of the batch and the draws, so a test can hand it the JAX
function's own draws. Not kept from the JAX function: its TPU tuning (the
mirror-conjugation merge of the signs, constant-folded matrices, the
one-hot bf16 product that applies the equalize LUT).

Train-time crops come from the packed square, not the original frame, so
crops near a long image's edges are out of reach and small crops are
upsampled from the packed resolution.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

N_GEO = 5  # rotate, shear x / y, translate x / y
N_OPS = 15  # with the ten elementwise ops: the rand-inc1 policy
# (sign, magnitude offset in units of mag_std) of each geometric op's
# slots: three quantised levels x two signs
GEO_VARIANTS = [(s, lv) for lv in (-1.0, 0.0, 1.0) for s in (1.0, -1.0)]
RRC_TRIES = 10
EQ_STRIDE = 4  # equalize's histogram samples every 4th row and column


def balanced_split(total: int, parts: int) -> list:
    base, rem = divmod(total, parts)
    return [base + (1 if i < rem else 0) for i in range(parts)]


# --------------------------------------------------------------- resampler

def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic (a = -0.5) at |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _weights(in_size: int, out_size: int, inv_scale: torch.Tensor,
             shift: torch.Tensor) -> torch.Tensor:
    """(B, out_size, in_size) resampling weights, per image b: output
    pixel o samples the input at (o + 0.5) * inv_scale[b] - shift[b] - 0.5,
    the kernel widened by inv_scale where it shrinks; each row normalised,
    zero where the sample lies outside the input (JAX's
    compute_weight_mat, transposed)."""
    dev = inv_scale.device
    sample = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5)
              * inv_scale[:, None] - shift[:, None] - 0.5)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    x = (sample[:, :, None]
         - torch.arange(in_size, dtype=torch.float32, device=dev)).abs() \
        / kernel_scale[:, None, None]
    w = _keys_cubic(x)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return w * inside[..., None]


def scale_translate(img: torch.Tensor, out_hw: Tuple[int, int],
                    scale: torch.Tensor, translation: torch.Tensor
                    ) -> torch.Tensor:
    """jax.image.scale_and_translate(img, (B, oh, ow, C), (1, 2), scale,
    translation, "cubic") with a (scale, translation) per image: img (B, H,
    W, C) float32, scale and translation (B, 2) as (y, x)."""
    inv = 1.0 / scale
    wy = _weights(img.shape[1], out_hw[0], inv[:, 0],
                  translation[:, 0] * inv[:, 0])
    wx = _weights(img.shape[2], out_hw[1], inv[:, 1],
                  translation[:, 1] * inv[:, 1])
    rows = torch.einsum("boh,bhwc->bowc", wy, img)
    return torch.einsum("bpw,bowc->bopc", wx, rows).contiguous()


def resize_square(images: torch.Tensor, size: int) -> torch.Tensor:
    """jax.image.resize(images, (B, size, size, C), "bicubic") of square
    float32 images (antialiased when it shrinks)."""
    scale = torch.full((images.shape[0], 2), size / images.shape[1],
                       dtype=torch.float32, device=images.device)
    return scale_translate(images, (size, size), scale,
                           torch.zeros_like(scale))


# --------------------------------------------------------------------- RRC

def rrc_boxes(s: int, area: torch.Tensor, log_ratio: torch.Tensor,
              xy: torch.Tensor) -> tuple:
    """(x0, y0, cw, ch), float32 (B,) each, of the crops of S x S squares:
    the first of the RRC_TRIES (area fraction, log aspect) tries whose box
    fits, else the whole square, at offset floor(u * (S - side + 1))."""
    areas = (s * s) * area
    aspects = torch.exp(log_ratio)
    cws = torch.round(torch.sqrt(areas * aspects))
    chs = torch.round(torch.sqrt(areas / aspects))
    valid = (cws > 0) & (cws <= s) & (chs > 0) & (chs <= s)
    first = valid.to(torch.int32).argmax(1, keepdim=True)
    any_valid = valid.any(1)
    full = torch.full_like(any_valid, s, dtype=torch.float32)
    cw = torch.where(any_valid, cws.gather(1, first)[:, 0], full)
    ch = torch.where(any_valid, chs.gather(1, first)[:, 0], full)
    x0 = torch.floor(xy[:, 0] * (s - cw + 1))
    y0 = torch.floor(xy[:, 1] * (s - ch + 1))
    return x0, y0, cw, ch


def rrc_apply(img: torch.Tensor, out_px: int, area: torch.Tensor,
              log_ratio: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """The random resized crops of float32 (B, S, S, 3) squares to
    (B, out_px, out_px, 3)."""
    x0, y0, cw, ch = rrc_boxes(img.shape[1], area, log_ratio, xy)
    sx, sy = out_px / cw, out_px / ch
    return scale_translate(img, (out_px, out_px),
                           torch.stack([sy, sx], 1),
                           torch.stack([-y0 * sy, -x0 * sx], 1))


# ------------------------------------------------------------ geometric ops

def geo_matrix(op: int, sign: float, magnitude: float, h: int,
               w: int) -> tuple:
    """The PIL-frame matrix (a, b, c, d, e, f) of warp op ``op`` (0 rotate,
    1 shear x, 2 shear y) at one sign and level: output (x, y) samples the
    input at (a x + b y + c, d x + e y + f)."""
    if op == 0:
        rad = magnitude / 9.0 * 30.0 * sign * math.pi / 180.0
        cx, cy = w / 2.0, h / 2.0
        cos, sin = math.cos(rad), math.sin(rad)
        return (cos, -sin, cx - cos * cx + sin * cy,
                sin, cos, cy - sin * cx - cos * cy)
    sv = magnitude / 9.0 * 0.3 * sign
    return ((1.0, sv, 0.0, 0.0, 1.0, 0.0) if op == 1 else
            (1.0, 0.0, 0.0, sv, 1.0, 0.0))


def translate_px(op: int, sign: float, magnitude: float, h: int,
                 w: int) -> int:
    """The integer shift of translate op 3 (x) or 4 (y): out(p) = in(p +
    shift) along its axis."""
    shift = int(magnitude / 9.0 * 0.45 * (w if op == 3 else h))
    return shift if sign > 0 else -shift


def affine_warp(img: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Bilinear warp of float32 (B, H, W, C) by one matrix a row of ``mats``
    (B, 6), PIL's half-pixel frame, zero outside the image. Computed in
    float64: grid_sample's float32 coordinates differ between devices by
    ~3e-5 pixels, which a sharp edge turns into ~1e-2 of 255."""
    b, h, w, _ = img.shape
    dev = img.device
    ys = torch.arange(h, dtype=torch.float64, device=dev)[:, None] + 0.5
    xs = torch.arange(w, dtype=torch.float64, device=dev)[None, :] + 0.5
    m = mats.to(torch.float64)[:, :, None, None]
    # grid_sample's align_corners=False frame: pixel i spans [i, i + 1)
    # of [0, W), so the sample point p maps to 2 p / W - 1
    xin = m[:, 0] * xs + m[:, 1] * ys + m[:, 2]
    yin = m[:, 3] * xs + m[:, 4] * ys + m[:, 5]
    grid = torch.stack([2.0 * xin / w - 1.0, 2.0 * yin / h - 1.0], -1)
    out = F.grid_sample(img.permute(0, 3, 1, 2).to(torch.float64), grid,
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.permute(0, 2, 3, 1).to(torch.float32)


def shift_images(img: torch.Tensor, dx: torch.Tensor,
                 dy: torch.Tensor) -> torch.Tensor:
    """out[b, y, x] = img[b, y + dy[b], x + dx[b]], zero outside: the
    translates, exact."""
    b, h, w, _ = img.shape
    dev = img.device
    ix = torch.arange(w, device=dev)[None, :] + dx[:, None]
    iy = torch.arange(h, device=dev)[None, :] + dy[:, None]
    vx, vy = (ix >= 0) & (ix < w), (iy >= 0) & (iy < h)
    out = img[torch.arange(b, device=dev)[:, None, None],
              iy.clamp(0, h - 1)[:, :, None], ix.clamp(0, w - 1)[:, None, :]]
    return out * (vy[:, :, None] & vx[:, None, :])[..., None]


# -------------------------------------------------------- elementwise ops
# op(img (B, H, W, 3) float32 in [0, 255], mag (B,), u (B,)) -> the same
# shape; data/transforms.py's magnitude mappings, mag in [0, 10].

def _per_image(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None]


def _gray(img):
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]


def autocontrast(img, mag, u):
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    out = (img - lo) * (255.0 / torch.clamp(hi - lo, min=1e-5))
    return torch.where(hi > lo, out, img)


def equalize(img, mag, u):
    """PIL's ImageOps.equalize per channel, the histogram from a stride-4
    sample: lut[i] = (step // 2 + sum_{j<i} hist[j]) // step with step =
    (n - count of the last nonzero bin) // 255; identity where step is 0."""
    b, h, w, c = img.shape
    sample = torch.round(img[:, ::EQ_STRIDE, ::EQ_STRIDE]).clamp(0, 255)
    sample = sample.to(torch.int64).permute(0, 3, 1, 2).reshape(b * c, -1)
    n = sample.shape[1]
    hist = torch.zeros(b * c, 256, dtype=torch.int64, device=img.device)
    hist.scatter_add_(1, sample, torch.ones_like(sample))
    last = 255 - (hist > 0).flip(1).to(torch.int32).argmax(1, keepdim=True)
    step = (n - hist.gather(1, last)) // 255
    cum = torch.cumsum(hist, 1) - hist
    ident = torch.arange(256, device=img.device).expand_as(hist)
    lut = torch.where(step > 0, (step // 2 + cum) // step.clamp(min=1),
                      ident).clamp(0, 255)
    pix = torch.round(img).clamp(0, 255).to(torch.int64)
    pix = pix.permute(0, 3, 1, 2).reshape(b * c, -1)
    out = lut.gather(1, pix).to(torch.float32)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


def invert(img, mag, u):
    return 255.0 - img


def posterize(img, mag, u):
    bits = torch.clamp(8 - (mag / 9.0 * 4).to(torch.int32), min=1)
    mask = torch.bitwise_left_shift(torch.full_like(bits, 0xFF),
                                    8 - bits) & 0xFF
    return (torch.round(img).to(torch.int32)
            & _per_image(mask)).to(torch.float32)


def solarize(img, mag, u):
    thr = torch.clamp(torch.trunc(256.0 - mag / 9.0 * 256.0), min=0.0)
    return torch.where(img >= _per_image(thr), 255.0 - img, img)


def solarize_add(img, mag, u):
    add = _per_image(torch.floor(mag / 9.0 * 110.0))
    return torch.where(img < 128.0, torch.clamp(img + add, 0, 255), img)


def _enhance_factor(mag, u):
    sign = torch.where(u < 0.5, 1.0, -1.0)
    return _per_image(torch.clamp(1.0 + (mag / 9.0) * 0.9 * sign, min=0.1))


def color(img, mag, u):
    g = _gray(img)
    return g + _enhance_factor(mag, u) * (img - g)


def contrast(img, mag, u):
    # PIL blends with the grey image's mean, rounded
    mean = torch.floor(_gray(img).mean(dim=(1, 2, 3)) + 0.5)
    mean = _per_image(mean)
    return mean + _enhance_factor(mag, u) * (img - mean)


def brightness(img, mag, u):
    return _enhance_factor(mag, u) * img


def sharpness(img, mag, u):
    """PIL's SMOOTH kernel [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13 on the
    interior; the border rows and columns stay as they are."""
    p = F.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1),
              mode="replicate").permute(0, 2, 3, 1)
    sm = (p[:, :-2, :-2] + p[:, :-2, 1:-1] + p[:, :-2, 2:]
          + p[:, 1:-1, :-2] + 5.0 * p[:, 1:-1, 1:-1] + p[:, 1:-1, 2:]
          + p[:, 2:, :-2] + p[:, 2:, 1:-1] + p[:, 2:, 2:]) / 13.0
    interior = torch.zeros(img.shape[1:3], dtype=torch.bool,
                           device=img.device)
    interior[1:-1, 1:-1] = True
    sm = torch.where(interior[None, :, :, None], sm, img)
    return sm + _enhance_factor(mag, u) * (img - sm)


EW_OPS = [autocontrast, equalize, invert, posterize, solarize, solarize_add,
          color, contrast, brightness, sharpness]


@functools.lru_cache(maxsize=None)
def layer_plan(b: int, magnitude: float, mag_std: float) -> tuple:
    """The ops of a layer's B slots, in slot order: (op, sign, level) for
    the geometric ops' slots (ops 0-4, each split over GEO_VARIANTS at the
    level clamped to [0, 10]), then (op, 0, 0) for the elementwise ops'."""
    counts = balanced_split(b, N_OPS)
    plan = []
    for op in range(N_GEO):
        sub = balanced_split(counts[op], len(GEO_VARIANTS))
        for (sign, lv), n in zip(GEO_VARIANTS, sub):
            level = min(10.0, max(0.0, float(magnitude) + float(mag_std) * lv))
            plan += [(op, sign, level)] * n
    for op in range(N_GEO, N_OPS):
        plan += [(op, 0.0, 0.0)] * counts[op]
    return tuple(plan)


@functools.lru_cache(maxsize=None)
def layer_consts(b: int, h: int, w: int, magnitude: float, mag_std: float,
                 device: torch.device) -> tuple:
    """layer_plan's constants on ``device``, made once per shape and level
    so that a step copies nothing from the host (each copy from pageable
    memory would wait for the stream): (n_warp, n_geo, the warps' (n_warp,
    6) matrices, the translates' (n_geo - n_warp,) dx and dy)."""
    plan = layer_plan(b, magnitude, mag_std)
    ops = [p[0] for p in plan]
    n_warp = sum(op < 3 for op in ops)  # rotate and shear
    n_geo = sum(op < N_GEO for op in ops)
    mats = torch.tensor([geo_matrix(op, s, lvl, h, w)
                         for op, s, lvl in plan[:n_warp]],
                        dtype=torch.float32).reshape(n_warp, 6)
    shifts = [(op, translate_px(op, s, lvl, h, w))
              for op, s, lvl in plan[n_warp:n_geo]]
    dx = torch.tensor([sh if op == 3 else 0 for op, sh in shifts],
                      dtype=torch.int64)
    dy = torch.tensor([sh if op == 4 else 0 for op, sh in shifts],
                      dtype=torch.int64)
    return (n_warp, n_geo) + tuple(t.to(device) for t in (mats, dx, dy))


def ra_layer(imgs: torch.Tensor, perm: torch.Tensor, mags: torch.Tensor,
             u_signs: torch.Tensor, magnitude: float,
             mag_std: float) -> torch.Tensor:
    """One RandAugment layer of float32 (B, H, W, 3) images: slot j holds
    image perm[j], takes layer_plan's op j (the geometric ops at their
    slot's sign and level, the elementwise ones at mags[j] and
    u_signs[j]), and the result, clipped to [0, 255], goes back to image
    perm[j]."""
    b, h, w, _ = imgs.shape
    ops = [p[0] for p in layer_plan(b, magnitude, mag_std)]
    n_warp, n_geo, mats, dx, dy = layer_consts(b, h, w, magnitude, mag_std,
                                               imgs.device)
    x = imgs[perm]
    outs = []
    if n_warp:
        outs.append(affine_warp(x[:n_warp], mats))
    if n_geo > n_warp:
        outs.append(shift_images(x[n_warp:n_geo], dx, dy))
    start = n_geo
    for op in range(N_GEO, N_OPS):
        count = ops.count(op)
        if count:
            sl = slice(start, start + count)
            outs.append(EW_OPS[op - N_GEO](x[sl], mags[sl], u_signs[sl]))
            start += count
    y = torch.clamp(torch.cat(outs), 0.0, 255.0)
    out = torch.empty_like(y)
    out[perm] = y
    return out


# ---------------------------------------------------------------- pipeline

def parse_rand_augment(aa: Optional[str]) -> Optional[dict]:
    """A timm aa string -> {num_ops, magnitude, mag_std}, with
    transforms.build_aug_policy's rand grammar; None for no aa; ValueError
    for a policy that is not rand-* (AugMix and --aug-splits run on the
    host)."""
    if not aa:
        return None
    if not aa.startswith("rand"):
        raise ValueError(
            f"device-side aug supports rand-* policies only, got {aa!r} "
            "(use the host PIL pipeline for augmix/--aug-splits)")
    mag, mag_std, num_ops = 9.0, 0.5, 2
    for tok in aa.split("-")[1:]:
        if tok.startswith("mstd"):
            mag_std = float(tok[4:])
        elif tok.startswith("m"):
            mag = float(tok[1:])
        elif tok.startswith("n"):
            num_ops = int(tok[1:])
    return {"num_ops": num_ops, "magnitude": mag, "mag_std": mag_std}


class AugDraws(NamedTuple):
    """One batch's draws: area fractions and log aspect ratios (B, 10),
    offsets (B, 2) and flip uniforms (B,) of the crop; per RandAugment
    layer (permutation (B,), magnitudes (B,), sign uniforms (B,))."""
    area: torch.Tensor
    log_ratio: torch.Tensor
    xy: torch.Tensor
    flip: torch.Tensor
    layers: Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]


class DeviceAug:
    """Random resized crop to img_size, flip with probability ``hflip`` and
    the rand-* policy ``auto_augment``: (gen, uint8 (B, S, S, 3)) -> float32
    (B, img_size, img_size, 3) in [0, 255], on the images' device."""

    def __init__(self, img_size: int = 224, hflip: float = 0.5,
                 auto_augment: Optional[str] = "rand-m9-mstd0.5-inc1",
                 scale: Tuple[float, float] = (0.08, 1.0),
                 ratio: Tuple[float, float] = (3 / 4, 4 / 3)):
        self.img_size = img_size
        self.hflip = hflip
        self.scale = tuple(scale)
        self.log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        self.ra = parse_rand_augment(auto_augment)

    def draw(self, gen: torch.Generator, b: int,
             device: torch.device) -> AugDraws:
        def uniform(shape, lo=0.0, hi=1.0):
            u = torch.rand(shape, generator=gen, device=device)
            return lo + u * (hi - lo)

        area = uniform((b, RRC_TRIES), *self.scale)
        log_ratio = uniform((b, RRC_TRIES), *self.log_ratio)
        xy = uniform((b, 2))
        flip = uniform((b,))
        layers = []
        for _ in range(self.ra["num_ops"] if self.ra else 0):
            perm = torch.randperm(b, generator=gen, device=device)
            noise = torch.randn(b, generator=gen, device=device)
            mags = torch.clamp(self.ra["magnitude"]
                               + self.ra["mag_std"] * noise, 0.0, 10.0)
            layers.append((perm, mags, uniform((b,))))
        return AugDraws(area, log_ratio, xy, flip, tuple(layers))

    def apply(self, images_u8: torch.Tensor, draws: AugDraws
              ) -> torch.Tensor:
        img = rrc_apply(images_u8.to(torch.float32), self.img_size,
                        draws.area, draws.log_ratio, draws.xy)
        if self.hflip > 0:
            img = torch.where(_per_image(draws.flip) < self.hflip,
                              img.flip(2), img)
        img = torch.clamp(img, 0.0, 255.0)
        for perm, mags, u_signs in draws.layers:
            img = ra_layer(img, perm, mags, u_signs, self.ra["magnitude"],
                           self.ra["mag_std"])
        return img

    def __call__(self, gen: torch.Generator,
                 images_u8: torch.Tensor) -> torch.Tensor:
        return self.apply(images_u8, self.draw(gen, images_u8.shape[0],
                                               images_u8.device))


def center_crop(images: torch.Tensor, out_px: int) -> torch.Tensor:
    """The centred out_px square of (B, S, S, C) packed squares (the eval
    crop; pack at >= out_px / crop_pct for the reference's framing)."""
    s = images.shape[1]
    if s < out_px:
        raise ValueError(f"packed px {s} < crop {out_px}")
    y0 = (s - out_px) // 2
    return images[:, y0:y0 + out_px, y0:y0 + out_px, :]
