"""PyTorch port, the S stage kernel's order of work and schedule on the CPU.

csrc/s_stage.cu runs the S block's own tiles (block_tc.cuh's k_qkv_wg and
k_tail_wg bodies, attn_tc.cuh's attention tiles) as the work items of one
persistent launch. Its order of work is the chain of s_block kernels':
``fused_block.s_stage_tiles_plain`` (a stage of ``s_block_tiles_plain``,
x and c rounded to the input type between blocks) is held here against the
JAX package's ``pallas_block.s_stage`` in interpret mode in fp32 (3e-5, the
JAX suite's tolerance for fused blocks) with and without CPEs, 2-3 blocks,
an 8x8 image and a ragged N = 20 (img_w 5), M = 16; and in bf16 against
``s_stage_plain`` in fp32 within chip_smoke.py's STAGE_TOL (|err| <= 3e-2
(max|ref| + |ref|): x is rounded to bf16 between blocks, so an element's
error follows the tensor's scale).

The schedule the kernel executes, ``fused_block.stage_schedule``, is
checked as a pure function at the stages chip_smoke.py times (base's stages
3 and 4 at B = 64, lemevit_tiny's stage 3, UperNet's stage 3 at B = 8, N =
1024; bf16) and at C = 640 in fp32 (the 32-row tails), with and without
the CPE: each item appears exactly once; its images are the ones it
touches; the counts are each phase's items per image in every block; every
wait lies earlier in the list (tickets taken in order cannot deadlock) and
an item of block j + 1 waits, through the chain, for every item of block j
of its images (so a counter at wait_mult * counts means those blocks are
done); every row an item reads, the CPE's neighbour rows included, was last
written by the item that should have written it, which the item waits for;
and no item overwrites a row that an item it does not wait for still reads.
The card checks the kernel against the chain and these models
(tests/test_torch_gpu.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lemevit_tpu.attn import pallas_block
from lemevit_tpu_torch.attn import fused_block as fb

C, H, M = 64, 2, 16
TOL = dict(rtol=3e-5, atol=3e-5)
STAGE_TOL = 3e-2


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_block, "_INTERPRET", True)


def _case(nb, b, n, cpe, seed):
    """(x, c, params, cpes or None) as fp32 numpy, every value rounded to
    bf16 first so both dtypes see the same numbers; proj and fc2 scaled by
    (2 nb)^-1/2 so x keeps its scale over the stage."""
    rng = np.random.RandomState(seed)

    def lin(out, inp, scale=1.0):
        return [scale * rng.randn(out, inp) / np.sqrt(inp),
                0.1 * rng.randn(out)]

    def ln():
        return [1 + 0.1 * rng.randn(C), 0.1 * rng.randn(C)]

    res = (2 * nb) ** -0.5
    params = [ln() + lin(3 * C, C) + lin(C, C, res) + ln() + lin(2 * C, C)
              + lin(C, 2 * C, res) for _ in range(nb)]
    cpes = [[0.3 * rng.randn(9, C), 0.1 * rng.randn(C)]
            for _ in range(nb)] if cpe else None
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(  # noqa
        torch.bfloat16).float().numpy()
    return (bf(rng.randn(b, n, C)), bf(rng.randn(b, M, C)),
            [[bf(a) for a in p] for p in params],
            None if cpes is None else [[bf(a) for a in cp] for cp in cpes])


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax_layout(params):
    """torch Linear (out, in) -> the Pallas kernels' (in, out)."""
    return tuple(jnp.asarray(a.T if a.ndim == 2 else a) for a in params)


STAGES = [(3, 8, 8), (2, 4, 5)]  # (blocks, image height, image width)


@pytest.mark.parametrize("use_cpe", [False, True], ids=["no_cpe", "cpe"])
@pytest.mark.parametrize("nb,img_h,img_w", STAGES, ids=["8x8", "n20"])
def test_s_stage_tiles_matches_jax_stage(nb, img_h, img_w, use_cpe):
    n = img_h * img_w
    x, c, params, cpes = _case(nb, 2, n, use_cpe, 40 + n + use_cpe)
    want = pallas_block.s_stage(
        jnp.asarray(x), jnp.asarray(c), [_jax_layout(p) for p in params],
        num_heads=H, img_w=img_w,
        cpes=None if cpes is None else [tuple(map(jnp.asarray, cp))
                                        for cp in cpes])
    assert want is not None
    got = fb.s_stage_tiles_plain(
        torch.from_numpy(x), torch.from_numpy(c),
        [_torch(p) for p in params], num_heads=H, img_w=img_w,
        cpes=None if cpes is None else [_torch(cp) for cp in cpes])
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **TOL)


@pytest.mark.parametrize("nb,img_h,img_w", STAGES, ids=["8x8", "n20"])
def test_s_stage_tiles_bf16_within_stage_tol(nb, img_h, img_w):
    """The bf16 tile model (the kernel's roundings) against s_stage_plain
    in fp32 on the same bf16 numbers, with CPEs."""
    n = img_h * img_w
    x, c, params, cpes = _case(nb, 2, n, True, 60 + n)
    bf = torch.bfloat16
    got = fb.s_stage_tiles_plain(
        *_torch([x, c], bf), [_torch(p, bf) for p in params], num_heads=H,
        img_w=img_w, cpes=[_torch(cp, bf) for cp in cpes])
    want = fb.s_stage_plain(
        *_torch([x, c]), [_torch(p) for p in params], num_heads=H,
        img_w=img_w, cpes=[_torch(cp) for cp in cpes])
    for g_, w_ in zip(got, want):
        assert g_.dtype == bf and g_.shape == w_.shape
        err = (g_.float() - w_).abs()
        assert (err <= STAGE_TOL * (w_.abs().max() + w_.abs())).all(), \
            err.max().item()


# ---------------------------------------------------------------- schedule


def _cdiv(a, b):
    return -(-a // b)


def _model(nb, b, n, m, ch, heads, dtype, cpe, img_w, qkv_tiles):
    """What each item of s_stage.cu reads and writes, from its fields:
    accesses(kind, j, s, idx, g) -> (reads [(buffer, r0, r1, the (phase,
    block) that must have written those rows last, or None for the stage's
    input)], writes [(buffer, r0, r1)])."""
    seq, rows = (n, m), (b * n, b * m)
    tail_rows = fb.STAGE_ROWS if ch <= 512 else fb.STAGE_TAIL_ROWS_WIDE
    q = fb.ATTN_QUERIES[dtype]

    def accesses(kind, j, s, idx, g):
        x = s == 0
        src = ("in_x" if x else "in_c") if j == 0 else ("xo" if x else "co")
        prev = None if j == 0 else (fb.TAIL, j - 1)
        if kind == fb.QKV:
            r0 = idx * fb.STAGE_ROWS
            r1 = min(rows[s], r0 + fb.STAGE_ROWS)
            lo, hi = r0, r1
            if cpe and x:  # the 3x3 neighbours, within each row's image
                lo = max(r0 // n * n, r0 - img_w - 1)
                hi = min(((r1 - 1) // n + 1) * n, r1 + img_w + 1)
            writes = [("qkv_x" if x else "qkv_c", r0, r1)]
            if cpe and x and g == 0:
                writes.append(("xa", r0, r1))
            return [(src, lo, hi, prev)], writes
        if kind == fb.ATTN:
            sn = seq[s]
            reads, writes = [], []
            qkv, o = ("qkv_x", "o_x") if x else ("qkv_c", "o_c")
            if sn <= fb.SMALL_N:
                units = range(idx, min(b * heads, idx + fb.UNITS_SMALL))
                spans = [(u // heads, 0, sn) for u in units]
            else:
                qb = _cdiv(sn, q)
                units = range(idx, min(b * heads * qb, idx + fb.UNITS_ROWS))
                spans = [(u // qb // heads, u % qb * q,
                          min(sn, (u % qb + 1) * q)) for u in units]
            for img, q0, q1 in spans:
                reads.append((qkv, img * sn, (img + 1) * sn, (fb.QKV, j)))
                writes.append((o, img * sn + q0, img * sn + q1))
            return reads, writes
        r0 = idx * tail_rows
        r1 = min(rows[s], r0 + tail_rows)
        o = "o_x" if x else "o_c"
        t = (("xa", r0, r1, (fb.QKV, j)) if cpe and x
             else (src, r0, r1, prev))
        return ([(o, r0, r1, (fb.ATTN, j)), t],
                [("xo" if x else "co", r0, r1)])

    return accesses


STREAM = {"in_x": 0, "xo": 0, "xa": 0, "qkv_x": 0, "o_x": 0,
          "in_c": 1, "co": 1, "qkv_c": 1, "o_c": 1}


def check_schedule(nb, b, n, m, ch, heads, dtype, cpe, img_w):
    items, counts, qkv_tiles = fb.stage_schedule(nb, b, n, m, ch, heads,
                                                 dtype)
    f = {name: i for i, name in enumerate(fb.STAGE_FIELDS)}
    seq, rows = (n, m), (b * n, b * m)
    tiles = _cdiv(3 * ch, fb.QKV_TILE)
    groups = _cdiv(tiles, qkv_tiles)
    assert (groups - 1) * qkv_tiles < tiles <= groups * qkv_tiles
    tail_rows = fb.STAGE_ROWS if ch <= 512 else fb.STAGE_TAIL_ROWS_WIDE

    # every item exactly once
    want = set()
    for j in range(nb):
        for s in (0, 1):
            want |= {(fb.QKV, j, s, rb, g)
                     for rb in range(_cdiv(rows[s], fb.STAGE_ROWS))
                     for g in range(groups)}
            if seq[s] <= fb.SMALL_N:
                units, per = b * heads, fb.UNITS_SMALL
            else:
                units = b * heads * _cdiv(seq[s], fb.ATTN_QUERIES[dtype])
                per = fb.UNITS_ROWS
            want |= {(fb.ATTN, j, s, u, 0) for u in range(0, units, per)}
            want |= {(fb.TAIL, j, s, rb, 0)
                     for rb in range(_cdiv(rows[s], tail_rows))}
    keys = [tuple(int(v) for v in r[:5]) for r in items]
    assert len(keys) == len(set(keys)) and set(keys) == want

    accesses = _model(nb, b, n, m, ch, heads, dtype, cpe, img_w, qkv_tiles)
    state = {k: dict(wp=np.full(rows[s], -1), wb=np.full(rows[s], -1),
                     rmax=np.full((3, rows[s]), -1),
                     img=np.arange(rows[s]) // seq[s])
             for k, s in STREAM.items()}
    # know[P, j, i]: what every item of phase P, block j touching image i
    # knew done when it started (h below), elementwise max; stamp[P] moves
    # when know[P] does (h is cached per wait while it stands still)
    know = np.full((3, nb, b, 3, b), -1)
    stamp, cache = [0, 0, 0], {}
    seen = np.zeros((3, b), int)  # items of each phase touching an image
    per_block = np.zeros((nb, 3, b), int)
    for row in items.tolist():
        kind, j, s, idx, g, first, last, wph, wmult = row
        reads, writes = accesses(kind, j, s, idx, g)
        imgs = [state[buf]["img"][r] for buf, r0, r1, *_ in reads + writes
                for r in (r0, r1 - 1)]
        assert (first, last) == (min(imgs), max(imgs)), row
        sl = slice(first, last + 1)
        # h[P, i] = x: every item of phase P, blocks <= x, touching image i
        # is done when this item starts (its own wait, then what the
        # awaited items knew when they started)
        key = (wph, wmult, first, last)
        if wmult > 0 and cache.get(key, (None, -1))[1] != stamp[wph]:
            assert (seen[wph, sl] >= wmult * counts[wph, sl]).all(), row
            h = know[wph, :wmult, sl].max(axis=(0, 1))
            h[wph, sl] = np.maximum(h[wph, sl], wmult - 1)
            cache[key] = (h, stamp[wph])
        h = cache[key][0] if wmult > 0 else np.full((3, b), -1)
        if j > 0:  # block j - 1 of its phase and images done first
            assert (h[kind, sl] >= j - 1).all(), row
        for buf, r0, r1, exp in reads:
            st = state[buf]
            if exp is None:
                assert (st["wp"][r0:r1] == -1).all(), (row, buf)
            else:
                assert ((st["wp"][r0:r1] == exp[0])
                        & (st["wb"][r0:r1] == exp[1])
                        & (h[exp[0], st["img"][r0:r1]] >= exp[1])).all(), \
                    (row, buf)
        own = {}
        for buf, r0, r1 in writes:
            st = state[buf]
            hit = (st["wp"][r0:r1] != kind) | (st["wb"][r0:r1] != j)
            if hit.any():
                img = st["img"][r0:r1][hit]
                rm = st["rmax"][:, r0:r1][:, hit]  # readers of the old rows
                wp = st["wp"][r0:r1][hit]          # ... and their writer
                assert ((rm < 0) | (h[:, img] >= rm)).all(), (row, buf)
                assert ((wp < 0) | (h[np.maximum(wp, 0), img]
                                    >= st["wb"][r0:r1][hit])).all(), \
                    (row, buf)
                st["wp"][r0:r1][hit] = kind
                st["wb"][r0:r1][hit] = j
                st["rmax"][:, r0:r1][:, hit] = -1
            own.setdefault(buf, []).append((r0, r1))
        for buf, r0, r1, _ in reads:  # read before its own write: internal
            rm = state[buf]["rmax"][kind, r0:r1]
            spans = [(max(w0, r0) - r0, min(w1, r1) - r0)
                     for w0, w1 in own.get(buf, []) if w0 < r1 and w1 > r0]
            if not spans:
                np.maximum(rm, j, out=rm)
                continue
            keep = np.ones(r1 - r0, bool)
            for a, z in spans:
                keep[a:z] = False
            rm[keep] = np.maximum(rm[keep], j)
        blk = know[kind, j, sl]
        if (h > blk).any():
            np.maximum(blk, h, out=blk)
            stamp[kind] += 1
        seen[kind, sl] += 1
        per_block[j, kind, sl] += 1
    assert (per_block == counts[None]).all()
    for buf in ("xo", "co"):  # the stage's output: the last block's tails
        assert (state[buf]["wp"] == fb.TAIL).all()
        assert (state[buf]["wb"] == nb - 1).all()


SCHEDULES = [
    ("base_stage3", 18, 64, 196, 384, 14, torch.bfloat16),
    ("base_stage4", 4, 64, 49, 512, 7, torch.bfloat16),
    ("tiny_stage3", 8, 64, 196, 192, 14, torch.bfloat16),
    ("upernet_stage3", 8, 8, 1024, 192, 32, torch.bfloat16),
]


@pytest.mark.parametrize("use_cpe", [False, True], ids=["no_cpe", "cpe"])
@pytest.mark.parametrize("label,nb,b,n,ch,img_w,dtype", SCHEDULES,
                         ids=[s[0] for s in SCHEDULES])
def test_stage_schedule(label, nb, b, n, ch, img_w, dtype, use_cpe):
    check_schedule(nb, b, n, M, ch, ch // 32, dtype, use_cpe, img_w)


def test_stage_schedule_wide_fp32():
    """C = 640 (the 32-row tails past C = 512), fp32's 64-query attention
    units, the qkv columns split over groups, three images per 64 rows."""
    check_schedule(2, 4, 49, M, 640, 20, torch.float32, True, 7)
