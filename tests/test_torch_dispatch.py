"""PyTorch port, dispatch by shape: under attn_backend="auto" a block or an
attention module whose kernel does not take its shapes composes in PyTorch
(as the JAX package composes where its kernels return None), decided from
shapes and dtypes alone before any launch, while "cuda" still calls the
kernel, which raises its ValueError. CPU tensors run the plain versions,
which take any shape; the tests below take them as on the card
(``modules.on_card``) where they hold the declines.

The predicates at each limit, on each side of it: head_dim 32, C <=
fused_block.MAX_DIM (fused_train.MAX_TRAIN_DIM in training), the MLP width
a multiple of 32, fp32 or bf16, and at most attn/dca.py's MAX_META[dtype]
meta tokens for the D kernels. Then LeMeBlock._fusable and each attention
module with use_kernel forced true on CPU tensors (the kernel functions
replaced by a stand-in that fails the test if called), declining a
head_dim-64, C-768, hidden-48 or M-320 shape and taking the released
shape; a declined module gives the composition's result."""
import pytest
import torch

from lemevit_tpu_torch.attn import dca as tdca
from lemevit_tpu_torch.attn import fused_block as fb
from lemevit_tpu_torch.attn import fused_train as ft
from lemevit_tpu_torch.attn import mhsa as tmhsa
from lemevit_tpu_torch.attn import modules as tmodules
from lemevit_tpu_torch.models import lemevit as tmod

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("ch,heads,hidden,dtype,want", [
    (64, 2, 256, F32, True),      # head_dim 32
    (64, 1, 256, F32, False),     # head_dim 64
    (96, 2, 384, F32, False),     # head_dim 48
    (640, 20, 2560, BF, True),    # C = MAX_DIM
    (672, 21, 2688, BF, False),   # C past MAX_DIM
    (64, 2, 32, F32, True),       # hidden a multiple of 32
    (64, 2, 48, F32, False),      # hidden 48
    (64, 2, 256, torch.float16, False),
])
def test_block_takes_limits(ch, heads, hidden, dtype, want):
    """fused_block.block_takes on each side of each width and type limit,
    for every block form."""
    for attn_type in ("S", "C", "D", "D2"):
        assert fb.block_takes(attn_type, ch, heads, hidden, 16,
                              dtype) is want


@pytest.mark.parametrize("dtype", [F32, BF], ids=["fp32", "bf16"])
def test_meta_limit_of_the_d_kernels(dtype):
    """D and D2 blocks take at most MAX_META[dtype] meta tokens, in
    inference and training; the S and C kernels have no such limit."""
    top = tdca.MAX_META[dtype]
    for attn_type in ("D", "D2"):
        assert fb.block_takes(attn_type, 64, 2, 256, top, dtype)
        assert not fb.block_takes(attn_type, 64, 2, 256, top + 1, dtype)
        assert ft.train_takes(attn_type, 64, 2, 256, top, dtype)
        assert not ft.train_takes(attn_type, 64, 2, 256, top + 1, dtype)
    for attn_type in ("S", "C"):
        assert fb.block_takes(attn_type, 64, 2, 256, top + 1, dtype)
        assert ft.train_takes(attn_type, 64, 2, 256, top + 1, dtype)
    assert tdca.kernel_takes(64, 2, top, dtype)
    assert not tdca.kernel_takes(64, 2, top + 1, dtype)


@pytest.mark.parametrize("ch,want", [(512, True), (544, False)])
def test_train_takes_width_limit(ch, want):
    """Training takes C <= MAX_TRAIN_DIM (inference up to MAX_DIM)."""
    heads = ch // 32
    assert ft.train_takes("S", ch, heads, 4 * ch, 16, BF) is want
    assert fb.block_takes("S", ch, heads, 4 * ch, 16, BF)


def test_attention_predicates():
    """mhsa.kernel_takes / dca.kernel_takes: head_dim 32, fp32 or bf16."""
    assert tmhsa.kernel_takes(64, 2, F32) and tmhsa.kernel_takes(64, 2, BF)
    assert not tmhsa.kernel_takes(64, 1, F32)
    assert not tmhsa.kernel_takes(64, 2, torch.float16)
    assert tdca.kernel_takes(64, 2, 16, BF)
    assert not tdca.kernel_takes(128, 2, 16, BF)
    assert not tdca.kernel_takes(64, 2, 16, torch.float16)


@pytest.fixture
def forced(monkeypatch):
    """use_kernel true for every backend but "torch" on CPU tensors, in the
    blocks and the modules, and CPU tensors taken as on the card, where the
    kernels' shape limits apply (on the CPU the plain versions take any
    shape)."""
    on = lambda backend, t: backend != "torch"
    monkeypatch.setattr(tmod, "use_kernel", on)
    monkeypatch.setattr(tmodules, "use_kernel", on)
    monkeypatch.setattr(tmodules, "on_card", lambda t: True)


def test_cpu_tensors_take_any_shape(monkeypatch):
    """With use_kernel forced on CPU tensors (the tests' way onto the kernel
    path), the plain versions run and take any shape: nothing declines."""
    on = lambda backend, t: backend != "torch"
    monkeypatch.setattr(tmod, "use_kernel", on)
    blk = tmod.LeMeBlock(64, 1, "S")  # head_dim 64
    assert blk._fusable(torch.zeros(1, 2, 4, 64), torch.zeros(1, 16, 64))
    assert tmodules.shapes_ok("auto", torch.zeros(1), False)
    monkeypatch.setattr(tmodules, "on_card", lambda t: True)
    assert not tmodules.shapes_ok("auto", torch.zeros(1), False)
    assert tmodules.shapes_ok("cuda", torch.zeros(1), False)


@pytest.mark.parametrize("ch,heads,attn_type,ratio,m,train,want", [
    (64, 2, "S", 4, 16, False, True),     # the released shape
    (64, 1, "S", 4, 16, False, False),    # head_dim 64
    (768, 24, "S", 4, 16, False, False),  # C 768 > MAX_DIM
    (544, 17, "S", 4, 16, False, True),   # C 544: inference takes it ...
    (544, 17, "S", 4, 16, True, False),   # ... training does not
    (32, 1, "S", 1.5, 16, False, False),  # hidden 48
    (32, 1, "D", 4, 320, False, False),   # M 320 > MAX_META
    (32, 1, "D2", 4, 320, True, False),
    (32, 1, "D", 4, 192, True, True),
    (32, 1, "C", 4, 320, False, True),    # the C kernel has no M limit
])
def test_block_fusable_declines(forced, ch, heads, attn_type, ratio, m,
                                train, want):
    """LeMeBlock._fusable under "auto" applies the kernels' shape limits
    in the compute type; under "cuda" the block still goes to its kernels,
    which raise for such shapes."""
    blk = tmod.LeMeBlock(ch, heads, attn_type, mlp_ratio=ratio)
    x, c = torch.zeros(1, 2, 4, ch), torch.zeros(1, m, ch)
    assert blk._fusable(x, c, train) is want
    blk.attn_backend = "cuda"
    assert blk._fusable(x, c, train)


def _refuse(*args, **kwargs):
    raise AssertionError("the kernel function was called for a shape it "
                         "does not take")


@pytest.mark.parametrize("attn_type,dim,heads,m", [
    ("S", 64, 1, 16), ("C", 64, 1, 32), ("D", 64, 1, 16),
    ("D2", 64, 1, 16), ("D", 32, 1, 320), ("D2", 32, 1, 320)],
    ids=["S-hd64", "C-hd64", "D-hd64", "D2-hd64", "D-m320", "D2-m320"])
def test_modules_compose_where_kernels_decline(forced, monkeypatch,
                                               attn_type, dim, heads, m):
    """An attention module under "auto" composes (the kernel function is
    not called) where its kernel's predicate says no, and gives the
    "torch" backend's result; under "cuda" it calls the kernel function."""
    from lemevit_tpu_torch.models.lemevit import _ATTN
    for name in ("mhsa", "sdpa"):
        monkeypatch.setattr(tmhsa, name, _refuse)
    monkeypatch.setattr(tdca, "dca", _refuse)
    torch.manual_seed(0)
    mod = _ATTN[attn_type](dim, heads)
    x = torch.randn(2, 32, dim)
    c = torch.randn(2, m if attn_type != "C" else 32, dim)
    args = (x,) if attn_type == "S" else (x, c)
    got = mod(*args)
    mod.attn_backend = "torch"
    want = mod(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    mod.attn_backend = "cuda"
    with pytest.raises(AssertionError, match="kernel function was called"):
        mod(*args)


def test_constructor_defaults_compose(forced):
    """LeMeViT's constructor defaults (head_dim 64, 128 meta tokens; depth
    cut to one block a stage) under "auto" with the kernels forced on:
    every block declines and composes, in inference and in a training
    step, and gives the "torch" backend's logits and gradients."""
    torch.manual_seed(0)
    m = tmod.LeMeViT(depth=(1, 1, 1, 1, 1), num_classes=10)
    for stage, ch in zip(m.stages, m.embed_dim):
        assert not stage[0]._fusable(torch.zeros(1, 8, 8, ch),
                                     torch.zeros(1, 128, ch))
    x = torch.randn(2, 64, 64, 3)
    state = {k: v.clone() for k, v in m.state_dict().items()}
    out = {}
    for backend in ("auto", "torch"):
        m.load_state_dict(state)  # the BatchNorms' running statistics
        m.set_attn_backend(backend)
        m.zero_grad()
        m.train()
        m(x).square().sum().backward()
        m.eval()
        with torch.no_grad():
            out[backend] = (m(x), [p.grad.clone() for p in m.parameters()
                                   if p.grad is not None])
    torch.testing.assert_close(out["auto"][0], out["torch"][0], rtol=0,
                               atol=0)
    for a, b in zip(out["auto"][1], out["torch"][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
