"""The per-op cost probe, counterpart of ``scripts/vpu_probe.py::build``.

  ew_probe(x, op, k)        -> x with ``op`` applied k times in fp32

x is a (rows, C) bf16 array; the result is rounded to bf16 once, after the
k passes. For a CUDA tensor ``ew_probe`` launches ``k_ew_probe<Op, K>``
(``probes/csrc/ew_probe.cu``) or raises; for a CPU tensor it runs
``ew_probe_plain``, the same passes in PyTorch. ``LAUNCHES["ew_probe.<op>"]``
counts the kernel's launches per op (k = 0 counts under the op passed).

The ops are vpu_probe's twelve (``OPS``): exp, exp2, recip 1 / (t + 1.001),
the two GELU forms of the JAX kernels (gelu_fast: the clipped tanh-erf form
of ``pallas_block._gelu(fast=True)``; gelu_full: the exact erf form, with
device ``erff`` as the port's kernels compute it), LayerNorm with unit
scale, zero bias, eps 1e-6 and fp32 statistics (``pallas_block._ln``), row
max (t - max_row t) and row sum (t / sum_row t) over C, fma t * 1.0001 +
0.001, the bf16 round trip, tanh, and vpu_probe's tanh-GELU (the same
coefficients as gelu_fast).

``slope_table`` times them by vpu_probe's method: the per-pass cost in us per
(R, C) tile is (t_K - t_0) / K / 64 on a (R * 64, C) array, with K = 4 for
the GELUs and ln and 8 for the rest.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from lemevit_tpu_torch import probes
from lemevit_tpu_torch.utils.profiling import HBM_BYTES_PER_S, cuda_ms

TILES = 64                                      # vpu_probe.main's grid
SHAPES = ((392, 1536), (784, 384), (1568, 784))  # its (R, C) tiles
KS = (0, 1, 2, 4, 8)                            # the kernel's K instances
MAX_COLS = 2048                                 # 32 lanes x 8 x 16 bytes
LN_EPS = 1e-6
_SQRT_HALF = 0.7071067811865476
# lemevit_tpu/attn/pallas_block.py:105 _ERF_TANH_P
ERF_TANH_P = (1.12812423, 0.10414107, -0.00181363)


def gelu_tanh(t):
    """vpu_probe._gelu_tanh, the clipped tanh-erf GELU (fp32)."""
    u = (t * _SQRT_HALF).clamp(-6.0, 6.0)
    a = u * (ERF_TANH_P[0] + u * u * (ERF_TANH_P[1] + u * u * ERF_TANH_P[2]))
    return 0.5 * t * (1.0 + torch.tanh(a))


def _ln(t):
    mu = t.mean(-1, keepdim=True)
    var = (t - mu).square().mean(-1, keepdim=True)
    return (t - mu) * torch.rsqrt(var + LN_EPS)


OPS = {
    "exp": torch.exp,
    "exp2": torch.exp2,
    "recip": lambda t: 1.0 / (t + 1.001),
    "gelu_fast": gelu_tanh,
    "gelu_full": lambda t: 0.5 * t * (1.0 + torch.erf(t * _SQRT_HALF)),
    "ln": _ln,
    "rowmax": lambda t: t - t.amax(-1, keepdim=True),
    "rowsum": lambda t: t / t.sum(-1, keepdim=True),
    "fma": lambda t: t * 1.0001 + 0.001,
    "cast_rt": lambda t: t.to(torch.bfloat16).float(),
    "tanh": torch.tanh,
    "gelu_tanh": gelu_tanh,
}
# one PyTorch call computing the op at k = 1 on the bf16 tensor, where one
# exists (the bf16 round trip of a bf16 tensor is a copy)
LIBRARY = {
    "cast_rt": torch.clone,
    "exp": torch.exp,
    "exp2": torch.exp2,
    "tanh": torch.tanh,
    "gelu_full": lambda x: F.gelu(x, approximate="none"),
    "ln": lambda x: F.layer_norm(x, (x.shape[-1],), eps=LN_EPS),
}
# rough fp32 operations per element and pass, for the operations bound
OP_FLOPS = {"exp": 4, "exp2": 2, "recip": 5, "gelu_fast": 20,
            "gelu_full": 30, "ln": 8, "rowmax": 2, "rowsum": 5, "fma": 2,
            "cast_rt": 2, "tanh": 10, "gelu_tanh": 20}
LAUNCHES = {f"ew_probe.{op}": 0 for op in OPS}
# outputs near zero, where ln's t - mu cancels, agree within this absolute
# error (the inputs are O(1)) whatever their bf16 steps
ATOL = 1e-6


def jax_k(op: str) -> int:
    """vpu_probe.main's K: 4 for the GELUs and ln, 8 for the rest."""
    return 4 if op.startswith("gelu") or op == "ln" else 8


def ew_probe_plain(x: torch.Tensor, op: str, k: int) -> torch.Tensor:
    """``op`` applied k times to x in fp32, rounded to x's dtype."""
    t = x.float()
    for _ in range(k):
        t = OPS[op](t)
    return t.to(x.dtype)


def ew_probe(x: torch.Tensor, op: str, k: int) -> torch.Tensor:
    """See the module docstring."""
    if op not in OPS:
        raise ValueError(f"ew_probe: unknown op {op!r}; one of {list(OPS)}")
    if not x.is_cuda:
        return ew_probe_plain(x, op, k)
    probes.check_cuda("ew_probe", x, dtype=torch.bfloat16)
    if x.dim() != 2 or x.shape[1] % 8 or x.shape[1] > MAX_COLS:
        raise ValueError(f"ew_probe: (rows, C) with C a multiple of 8 up to "
                         f"{MAX_COLS} expected, got {tuple(x.shape)}")
    if k not in KS:
        raise ValueError(f"ew_probe: k={k}; the kernel has K in {KS}")
    out = torch.empty_like(x)
    probes.launch("ew_probe", x, list(OPS).index(op), k, x, out,
                  x.shape[0], x.shape[1], counts=LAUNCHES,
                  key=f"ew_probe.{op}")
    return out


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance in bf16 steps between two bf16 tensors (an
    infinity is one step past the largest finite value; NaN against NaN is
    0, NaN against a number the largest distance)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    d = (ordered(a) - ordered(b)).abs()
    d = torch.where(a.isnan() & b.isnan(), 0, d)
    return torch.where(a.isnan() ^ b.isnan(), 1 << 16, d)


def max_ulps(k: int) -> int:
    """The tolerance of a k-pass result against its plain version: 1 bf16
    step up to k = 2; 2 at vpu_probe's K = 4 / 8, where k fp32 passes of
    each side's transcendentals (about an fp32 step apart each) and the
    ill-conditioned row sums of rowsum (a row whose sum nearly cancels)
    compound before the one bf16 rounding."""
    return 1 if k <= 2 else 2


def mismatches(got: torch.Tensor, want: torch.Tensor, k: int) -> dict:
    """{"max_ulp": the largest bf16-step distance, "bad": the elements
    beyond ``max_ulps(k)`` steps and ``ATOL``}."""
    d = ulp_distance(got, want)
    err = (got.float() - want.float()).abs()
    bad = (d > max_ulps(k)) & ~(err <= ATOL)
    return {"max_ulp": int(d.max()), "bad": int(bad.sum())}


def pass_bytes(rows: int, cols: int) -> int:
    """Bytes of one probe call: a bf16 read and a bf16 write per element."""
    return 2 * 2 * rows * cols


def probe_input(r: int, c: int, device, seed: int = 0) -> torch.Tensor:
    """vpu_probe.main's input: a (r * 64, c) standard normal bf16 array
    (numpy-free, from a seeded torch.Generator)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(r * TILES, c, generator=g).to(torch.bfloat16).to(
        device)


def slope_table(device, shapes=SHAPES, reps: int = 30) -> list:
    """vpu_probe.main on the card: per shape, the k = 0 pass's ms beside
    its bytes bound and each op's per-pass us per tile, (t_K - t_0) / K /
    64, CUDA events over ``reps`` warm calls."""
    rows = []
    for r, c in shapes:
        x = probe_input(r, c, device)
        base = cuda_ms(lambda: ew_probe(x, "fma", 0), reps)
        per = {}
        for op in OPS:
            k = jax_k(op)
            dt = cuda_ms(lambda: ew_probe(x, op, k), reps)
            per[op] = (dt - base) / k / TILES * 1e3
        rows.append({"r": r, "c": c, "base_ms": base, "us_per_pass": per,
                     "bound_ms": pass_bytes(*x.shape) / HBM_BYTES_PER_S
                     * 1e3})
    return rows


def format_row(row: dict) -> str:
    """One line of vpu_probe.main's table."""
    return " ".join([f"({row['r']:5d},{row['c']:5d}) "
                     f"base={row['base_ms']:6.3f}ms"] +
                    [f"{op}={us:6.2f}us"
                     for op, us in row["us_per_pass"].items()])
