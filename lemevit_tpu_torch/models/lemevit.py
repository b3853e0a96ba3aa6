"""LeMeViT backbone in PyTorch: counterpart of lemevit_tpu/models/lemevit.py.

Images enter NHWC; ``features_only=True`` returns the NHWC stride-4/8/16/32
feature maps instead of logits.
  - stem: two 3x3 s2 conv + BN, GELU between -> H/4;
  - stage i > 0 downsamples with a 3x3 s2 conv + BN, except after a "C"
    stage (identity: stages 0 and 1 share H/4);
  - learnable meta tokens (queries_len x embed_dim[0]), projected by a
    MetaTokenDownsample at the start of every stage;
  - LeMeBlock: depthwise CPE, norms and one MLP shared by the image and
    meta-token streams, four forms by attn_type;
  - head: BatchNorm(x) + LayerNorm(c, eps 1e-5), spatial mean + token mean,
    then Linear in float32.

A pre-norm block without layer-scale or MLP dwconv runs as hand-written
kernels where ``use_kernel(attn_backend, x)`` says so, the JAX package
would run its kernel at that token count (``kernel_takes``) and, under
"auto", the kernels take its shapes in the compute type
(``fused_block.block_takes`` / ``fused_train.train_takes``: head_dim 32,
C within the kernels' width, the MLP width a multiple of 32, at most
``MAX_META`` meta tokens in a D block); a block they do not take composes,
as the JAX package's does where its kernels return None, while "cuda"
calls the kernels, which raise for it:
  - inference (eval mode, autograd off): the whole-block kernels of
    attn/fused_block.py, for C, D/D2 and S blocks;
  - training (train mode, autograd on): the training kernels of
    attn/fused_train.py (autograd Functions), for C, D/D2 and S blocks,
    with the LayerNorm affines folded into the next product outside them
    and D2 mapped onto the D kernels by the same weight permutation.
By default the CPE stays outside the kernels as a depthwise conv; with
``cpe_in_kernel`` the inference kernels take the pre-CPE tokens and apply a
3x3 CPE themselves (the JAX package's ``PB_{S,D,C}_CPE=1``), and with
``train_cpe_in_kernel`` the training kernels do (``PB_TRAIN_CPE=fused``;
both off by default, as in the JAX package; a block whose CPE is not 3x3
then composes, as JAX's _try_fused_train declines it). With ``s_stage`` an
inference forward runs each "S" stage of two or more blocks as one
``fused_block.s_stage`` launch, its CPEs inside (``PB_S_STAGE=1``). Any
other block (post-norm, layer-scale, MLP dwconv, or above the token counts:
segmentation at 512^2, where stages 0-2 see 16384 and 4096 image tokens)
composes its norms, residuals and MLP, and its attention module hands the
attention to the attention-only kernels of attn/dca.py and attn/mhsa.py
under the same switch (attn/modules.py). Under ``torch.autocast`` the
kernels run in the autocast type, their weights cast per block as the JAX
package's ``.astype(dtype)`` does.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from lemevit_tpu_torch.attn import fused_block, fused_train
from lemevit_tpu_torch.attn import reference as ref
from lemevit_tpu_torch.attn.modules import (
    BACKENDS,
    CrossAttention,
    DualCrossAttention,
    DualCrossAttentionV2,
    StandardAttention,
    shapes_ok,
    use_kernel,
)
from lemevit_tpu_torch.core.layers import (
    BatchNorm,
    ConvBN,
    ConvStem,
    DropPath,
    DWConv,
    MetaTokenDownsample,
    Mlp,
    set_generator,
)

_ATTN = {"S": StandardAttention, "C": CrossAttention,
         "D": DualCrossAttention, "D2": DualCrossAttentionV2}

# Token counts up to which the JAX package runs a block kernel; above them
# it composes, and so does the port.
MAX_N_S_KERNEL = 1024       # lemevit_tpu/attn/pallas_block.py:38 _MAX_N_SBLOCK
MAX_N_BLOCK_KERNEL = 3136   # lemevit_tpu/models/lemevit.py:387 (C, D, D2)


def kernel_takes(attn_type: str, n: int) -> bool:
    """Whether a block of ``attn_type`` over ``n`` image tokens is within
    the token counts the JAX package runs its block kernels for."""
    return n <= (MAX_N_S_KERNEL if attn_type == "S" else MAX_N_BLOCK_KERNEL)


def compute_dtype(t: torch.Tensor) -> torch.dtype:
    """The type a block's kernels run in: the autocast type where autocast
    is on for t's device, else t's own."""
    dev = t.device.type
    if torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return t.dtype


def _branch(y: torch.Tensor, s: Optional[torch.Tensor]) -> torch.Tensor:
    """A residual branch times its per-image DropPath scale (B,), if any."""
    return y if s is None else y * s.view(-1, 1, 1).to(y.dtype)


class LeMeBlock(nn.Module):
    """One LeMeViT block. The norms, the MLP and the layer-scale gammas are
    shared by the image-token stream x and the meta-token stream c."""

    def __init__(self, dim: int, num_heads: int, attn_type: str,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 layer_scale_init_value: float = -1.0, cpe_ks: int = 3,
                 pre_norm: bool = True, mlp_dwconv: bool = False,
                 attn_backend: str = "auto", cpe_in_kernel: bool = False,
                 train_cpe_in_kernel: bool = False):
        super().__init__()
        if attn_type not in _ATTN:
            raise ValueError(f"unknown attn_type {attn_type!r}")
        if attn_backend not in BACKENDS:
            raise ValueError(f"attn_backend must be one of {BACKENDS}")
        self.attn_type = attn_type
        self.num_heads = num_heads
        # the inference / training kernels apply a 3x3 CPE to pre-CPE tokens
        self.cpe_in_kernel = cpe_in_kernel
        self.train_cpe_in_kernel = train_cpe_in_kernel
        self.pre_norm = pre_norm
        self.mlp_dwconv = mlp_dwconv
        self.pos_embed = DWConv(dim, cpe_ks) if cpe_ks > 0 else None
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _ATTN[attn_type](dim, num_heads, attn_backend)
        self.mlp = Mlp(dim, int(mlp_ratio * dim), use_dwconv=mlp_dwconv)
        self.drop_path = DropPath(drop_path)
        self.use_layer_scale = layer_scale_init_value > 0
        if self.use_layer_scale:
            self.gamma1 = nn.Parameter(torch.full((dim,),
                                                  layer_scale_init_value))
            self.gamma2 = nn.Parameter(torch.full((dim,),
                                                  layer_scale_init_value))

    @property
    def attn_backend(self) -> str:
        """The block's kernel switch ("auto", "torch" or "cuda"), held by
        its attention module, which reads it too."""
        return self.attn.attn_backend

    @attn_backend.setter
    def attn_backend(self, backend: str) -> None:
        if backend not in BACKENDS:
            raise ValueError(f"attn_backend must be one of {BACKENDS}")
        self.attn.attn_backend = backend

    # ------------------------------------------------------------ composition

    def _cpe(self, x):
        return x if self.pos_embed is None else x + self.pos_embed(x)

    def cpe_weights(self):
        """The CPE as the kernels take it: (taps (9, C) in (ky, kx) order,
        bias (C,)), or None where the block has no CPE (cpe_ks 0). Raises
        LookupError for a kernel size other than 3, as the JAX package's
        _cpe_weights does."""
        if self.pos_embed is None:
            return None
        if self.pos_embed.kernel_size != (3, 3):
            raise LookupError("the kernels' CPE is 3x3 only")
        w = self.pos_embed.weight  # (C, 1, 3, 3)
        return w.reshape(w.shape[0], 9).t().contiguous(), self.pos_embed.bias

    def _kernel_cpe(self):
        """The CPE the inference kernels apply (cpe_in_kernel and a 3x3
        CPE), else None: the CPE, if any, runs outside."""
        if not self.cpe_in_kernel:
            return None
        try:
            return self.cpe_weights()
        except LookupError:
            return None

    def _scaled(self, gamma: str, t):
        return getattr(self, gamma) * t if self.use_layer_scale else t

    def _residual_update(self, t, attn_out, hw, s1=None, s2=None):
        """Attention residual + MLP residual on one stream; s1 / s2 are the
        two branches' per-image DropPath scales (None: identity)."""
        if self.pre_norm:
            t = t + _branch(self._scaled("gamma1", attn_out), s1)
            return t + _branch(
                self._scaled("gamma2", self.mlp(self.norm2(t), hw)), s2)
        t = self.norm1(t + _branch(self._scaled("gamma1", attn_out), s1))
        return self.norm2(
            t + _branch(self._scaled("gamma2", self.mlp(t, hw)), s2))

    def _norm_in(self, t):
        return self.norm1(t) if self.pre_norm else t

    def dp_scales(self, batch: int, device) -> Optional[torch.Tensor]:
        """The (4, batch) DropPath branch scales of one training forward
        (attn-x, mlp-x, attn-c, mlp-c: four independent draws, as the JAX
        package's _dp_scales), or None where DropPath is the identity."""
        return self.drop_path.scales(4, batch, device)

    # ------------------------------------------------------------ fused

    def _fusable(self, x, c, train: bool = False) -> bool:
        """For NHWC tokens x and meta tokens c: the structural conditions of
        the fused kernels (the pre-norm form of every released variant),
        the JAX package's token-count limits, the backend switch, then,
        under "auto" on the card, the kernels' own shape limits in the
        compute type (``fused_train.train_takes`` with ``train``, else
        ``fused_block.block_takes``; ``attn/modules.py::shapes_ok``): a
        block they do not take composes, as the JAX package's does where
        its kernels return None. Under "cuda" the kernels are called and
        raise for such a block."""
        if not (self.pre_norm and not self.use_layer_scale
                and not self.mlp_dwconv
                and kernel_takes(self.attn_type, x.shape[1] * x.shape[2])
                and use_kernel(self.attn_backend, x)):
            return False
        takes = fused_train.train_takes if train else fused_block.block_takes
        return shapes_ok(self.attn_backend, x, takes(
            self.attn_type, x.shape[-1], self.num_heads,
            self.mlp.fc1.out_features, c.shape[1], compute_dtype(x)))

    def train_params(self) -> list:
        """The LN-folded parameter tuple of this block's training kernels
        (attn/fused_train.py's order): norm1 folded into each attention
        input projection (qkv; q and kv; qkv1 and qkv2) and norm2 into fc1,
        under autograd, so that autograd chains the LayerNorm affine
        gradients (the JAX package's _try_fused_train). Built on
        fused_params, so D2's permuted weights sum their duplicated
        columns' gradients."""
        p = self.fused_params()
        (g1, be1), attn, tail = p[:2], p[2:-6], p[-6:]
        n_in = 1 if self.attn_type == "S" else 2
        out = []
        for i in range(n_in):
            out += fused_train.fold_ln(g1, be1, attn[2 * i], attn[2 * i + 1])
        out += attn[2 * n_in:]
        out += fused_train.fold_ln(*tail[:4])
        return out + list(tail[4:])

    def _train_kernels(self, xt, c, dp, n: int, cpe=None, img_w: int = 0):
        """The block through its training kernels, weights (and ``cpe``,
        which they then apply to the pre-CPE xt) cast to the compute type.
        Returns (x_out, c_out); the C block's x_out is None (x passes it
        unchanged)."""
        dt = compute_dtype(xt)
        params = [t.to(dt) for t in self.train_params()]
        if dp is None:
            dp = torch.ones(4, xt.shape[0], device=xt.device)
        xt, c, dp = xt.to(dt), c.to(dt), dp.contiguous()
        kw = dict(num_heads=self.num_heads, img_w=img_w,
                  cpe=None if cpe is None else [t.to(dt) for t in cpe])
        if self.attn_type == "S":
            return fused_train.s_block_train(xt, c, params, dp, **kw)
        if self.attn_type == "C":
            return None, fused_train.c_block_train(xt, c, params, dp, **kw)
        scale_x, scale_c = ref.dca_scales(n, c.shape[1], xt.shape[-1])
        return fused_train.dca_block_train(xt, c, params, dp, scale_x=scale_x,
                                           scale_c=scale_c, **kw)

    def fused_params(self) -> tuple:
        """The parameter tuple of this block's fused kernel (fused_block's
        order, torch Linear layout). D2 maps onto the D kernel through the
        weight permutation [Wq|Wq|Wv1] / [Wk|Wk|Wv2]: q1 = k1 = q, v1 from x;
        q2 = k2 = k, v2 from c."""
        a = self.attn
        n1 = (self.norm1.weight, self.norm1.bias)
        tail = (self.norm2.weight, self.norm2.bias,
                self.mlp.fc1.weight, self.mlp.fc1.bias,
                self.mlp.fc2.weight, self.mlp.fc2.bias)
        if self.attn_type == "S":
            return (*n1, a.qkv.weight, a.qkv.bias, a.proj.weight,
                    a.proj.bias, *tail)
        if self.attn_type == "C":
            return (*n1, a.q.weight, a.q.bias, a.kv.weight, a.kv.bias,
                    a.proj.weight, a.proj.bias, *tail)
        if self.attn_type == "D":
            w1, b1, w2, b2 = (a.qkv1.weight, a.qkv1.bias,
                              a.qkv2.weight, a.qkv2.bias)
        else:
            ch = a.proj_x.weight.shape[0]
            wq, wv1 = a.qv1.weight[:ch], a.qv1.weight[ch:]
            bq, bv1 = a.qv1.bias[:ch], a.qv1.bias[ch:]
            wk, wv2 = a.kv2.weight[:ch], a.kv2.weight[ch:]
            bk, bv2 = a.kv2.bias[:ch], a.kv2.bias[ch:]
            w1, b1 = torch.cat([wq, wq, wv1]), torch.cat([bq, bq, bv1])
            w2, b2 = torch.cat([wk, wk, wv2]), torch.cat([bk, bk, bv2])
        return (*n1, w1, b1, w2, b2, a.proj_x.weight, a.proj_x.bias,
                a.proj_c.weight, a.proj_c.bias, *tail)

    # ------------------------------------------------------------ forward

    def forward(self, x, c, dp: Optional[torch.Tensor] = None):
        """x: (B, H, W, C) NHWC image tokens, c: (B, M, C) meta tokens.
        ``dp``: the (4, B) DropPath scales of a training forward
        (dp_scales), drawn here when not given."""
        b, h, w, ch = x.shape
        hw = (h, w)
        train = self.training and torch.is_grad_enabled()
        infer = not self.training and not torch.is_grad_enabled()
        fused = (train or infer) and self._fusable(x, c, train)
        if train and dp is None:
            dp = self.dp_scales(b, x.device)
        s1x, s2x, s1c, s2c = (None,) * 4 if dp is None else dp
        cpe = None
        if fused and infer:
            cpe = self._kernel_cpe()
        elif fused and self.train_cpe_in_kernel:
            try:
                cpe = self.cpe_weights()
            except LookupError:  # not 3x3: the block composes
                fused = False
        xt = (x if cpe is not None else self._cpe(x)).reshape(b, h * w, ch)
        if fused and train:
            xo, co = self._train_kernels(xt, c, dp, h * w, cpe, w)
            # the C block passes x (before the CPE) through unchanged
            return (x if xo is None else xo.reshape(b, h, w, ch)), co
        if fused:
            dt = compute_dtype(xt)
            xt, c = xt.to(dt), c.to(dt)
            params = [t.to(dt) for t in self.fused_params()]
            kw = dict(num_heads=self.num_heads, img_w=w,
                      cpe=None if cpe is None else [t.to(dt) for t in cpe])
        if self.attn_type == "C":
            # x passes through unchanged; only k/v see the CPE-shifted tokens
            if fused:
                return x, fused_block.c_block(xt, c, params, **kw)
            ac = self.attn(self._norm_in(xt), self._norm_in(c))
            return x, self._residual_update(c, ac, None, s1c, s2c)
        if fused:
            if self.attn_type == "S":
                xo, co = fused_block.s_block(xt, c, params, **kw)
            else:
                scale_x, scale_c = ref.dca_scales(h * w, c.shape[1], ch)
                xo, co = fused_block.dca_block(xt, c, params, scale_x=scale_x,
                                               scale_c=scale_c, **kw)
            return xo.reshape(b, h, w, ch), co
        if self.attn_type == "S":
            ax = self.attn(self._norm_in(xt))
            ac = self.attn(self._norm_in(c))
        else:
            ax, ac = self.attn(self._norm_in(xt), self._norm_in(c))
        xo = self._residual_update(xt, ax, hw, s1x, s2x)
        co = self._residual_update(c, ac, None, s1c, s2c)
        return xo.reshape(b, h, w, ch), co


class LeMeViT(nn.Module):
    """Hierarchical vision transformer with learnable meta tokens. Input
    (B, H, W, in_chans); output logits (B, num_classes) in float32, or with
    ``features_only`` the NHWC maps of ``out_indices``, the stages after
    the last of them not run."""

    def __init__(self, depth: Sequence[int] = (2, 3, 4, 8, 3),
                 in_chans: int = 3, num_classes: int = 1000,
                 embed_dim: Sequence[int] = (64, 64, 128, 320, 512),
                 head_dim: int = 64,
                 mlp_ratios: Sequence[float] = (4, 4, 4, 4, 4),
                 drop_path_rate: float = 0.0,
                 attn_type: Sequence[str] = ("C", "D", "D", "S", "S"),
                 queries_len: int = 128, cpe_ks: int = 3,
                 pre_norm: bool = True, mlp_dwconv: bool = False,
                 layer_scale_init_value: float = -1.0,
                 features_only: bool = False,
                 out_indices: Sequence[int] = (1, 2, 3, 4),
                 remat_stages: Sequence[int] = (),
                 attn_backend: str = "auto", s_stage: bool = False,
                 cpe_in_kernel: bool = False,
                 train_cpe_in_kernel: bool = False, freeze_bn: bool = False):
        super().__init__()
        dims = list(embed_dim)
        self.s_stage = s_stage
        self.freeze_bn = freeze_bn
        self.remat_stages = tuple(remat_stages)
        self.attn_type = tuple(attn_type)
        self.depth = tuple(depth)
        self.embed_dim = tuple(dims)
        self.num_classes = num_classes
        self.features_only = features_only
        self.out_indices = tuple(out_indices)
        n_stages = len(self.attn_type)

        self.downsample_layers = nn.ModuleList([ConvStem(in_chans, dims[0])])
        for i in range(n_stages - 1):
            self.downsample_layers.append(
                nn.Identity() if self.attn_type[i] == "C"
                else ConvBN(dims[i], dims[i + 1]))

        self.meta_tokens = nn.Parameter(torch.zeros(queries_len, dims[0]))
        self.meta_token_downsample = nn.ModuleList(
            [MetaTokenDownsample(dims[0], dims[0])]
            + [MetaTokenDownsample(dims[i], dims[i + 1])
               for i in range(n_stages - 1)])

        dp_rates = np.linspace(0.0, drop_path_rate, sum(depth)).tolist()
        self.stages = nn.ModuleList()
        cur = 0
        for i in range(n_stages):
            self.stages.append(nn.ModuleList([
                LeMeBlock(dims[i], dims[i] // head_dim, self.attn_type[i],
                          mlp_ratio=mlp_ratios[i],
                          drop_path=dp_rates[cur + j],
                          layer_scale_init_value=layer_scale_init_value,
                          cpe_ks=cpe_ks, pre_norm=pre_norm,
                          mlp_dwconv=mlp_dwconv, attn_backend=attn_backend,
                          cpe_in_kernel=cpe_in_kernel,
                          train_cpe_in_kernel=train_cpe_in_kernel)
                for j in range(depth[i])]))
            cur += depth[i]

        if not features_only:
            self.norm = BatchNorm(dims[-1], eps=1e-5)
            self.norm_c = nn.LayerNorm(dims[-1], eps=1e-5)
            self.head = (nn.Linear(dims[-1], num_classes)
                         if num_classes > 0 else None)

    def train(self, mode: bool = True) -> "LeMeViT":
        """With ``freeze_bn`` the stem's and the downsamples' BatchNorms
        stay in eval mode, normalising with their running statistics and
        leaving them as they are, while the model trains (detection
        fine-tuning; the JAX package's freeze_bn); the head's trains."""
        super().train(mode)
        if self.freeze_bn:
            for ds in self.downsample_layers:
                ds.eval()
        return self

    def set_attn_backend(self, backend: str) -> None:
        """Switch every block (and its attention module) between "auto",
        "torch" and "cuda"."""
        if backend not in BACKENDS:
            raise ValueError(f"attn_backend must be one of {BACKENDS}")
        for stage in self.stages:
            for blk in stage:
                blk.attn_backend = backend

    def set_generator(self, generator: torch.Generator,
                      shard: Optional[tuple] = None) -> None:
        """Draw every block's DropPath masks from ``generator`` (a
        torch.Generator on the activations' device); with ``shard`` (rank,
        world) over the global batch, this rank keeping its rows."""
        set_generator(self, generator, shard)

    def _try_s_stage(self, i: int, x, c):
        """Stage i in one ``fused_block.s_stage`` launch, the counterpart of
        the JAX package's LeMeViT._try_s_stage: only with ``s_stage``, in
        inference (eval mode, autograd off), for an "S" stage of two or more
        blocks whose first block would run its kernel, and where
        ``stage_takes`` holds. The blocks' CPEs always run inside. Returns
        (x, c), or None for the per-block path."""
        blocks = self.stages[i]
        if (not self.s_stage or self.training or torch.is_grad_enabled()
                or self.attn_type[i] != "S" or not blocks[0]._fusable(x, c)):
            return None
        b, h, w, ch = x.shape
        heads = blocks[0].num_heads
        try:
            cpes = [blk.cpe_weights() for blk in blocks]
        except LookupError:
            return None
        if all(cp is None for cp in cpes):
            cpes = None
        if not fused_block.stage_takes(h * w, c.shape[1], ch, heads,
                                       len(blocks), cpes):
            return None
        dt = compute_dtype(x)
        params_list = [[t.to(dt) for t in blk.fused_params()]
                       for blk in blocks]
        if cpes is not None:
            cpes = [[t.to(dt) for t in cp] for cp in cpes]
        xo, co = fused_block.s_stage(x.reshape(b, h * w, ch).to(dt),
                                     c.to(dt), params_list, num_heads=heads,
                                     cpes=cpes, img_w=w)
        return xo.reshape(b, h, w, ch), co

    def forward(self, x):
        x = x.to(self.meta_tokens.dtype)
        c = self.meta_tokens[None].expand(x.shape[0], -1, -1)
        feats = []
        for i, stage in enumerate(self.stages):
            x = self.downsample_layers[i](x)
            c = self.meta_token_downsample[i](c)
            remat = (i in self.remat_stages and self.training
                     and torch.is_grad_enabled())
            staged = self._try_s_stage(i, x, c)
            if staged is not None:
                x, c = staged
            for blk in stage if staged is None else ():
                if remat:
                    # the masks are drawn outside, so that the recomputed
                    # forward of the backward sees the same ones
                    x, c = checkpoint(blk, x, c,
                                      blk.dp_scales(x.shape[0], x.device),
                                      use_reentrant=False)
                else:
                    x, c = blk(x, c)
            if self.features_only and i in self.out_indices:
                feats.append(x)
                if i == max(self.out_indices):
                    if self.training and i + 1 < len(self.stages):
                        # the rest is dead work, but for the next
                        # downsample's BatchNorm statistics: they move as
                        # the JAX package's do
                        with torch.no_grad():
                            self.downsample_layers[i + 1](x)
                    break
        if self.features_only:
            return feats
        x = self.norm(x.permute(0, 3, 1, 2)).mean(dim=(2, 3))
        c = self.norm_c(c).mean(dim=1)
        x = (x + c).float()
        if self.head is not None:
            x = F.linear(x, self.head.weight.float(), self.head.bias.float())
        return x


@contextlib.contextmanager
def capture_block_inputs(model: LeMeViT
                         ) -> Iterator[List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Collect every block's (x, c) inputs, in order, over the forwards run
    inside the ``with``: the counterpart of the JAX package's
    ``sow("intermediates", "block_inputs", ...)`` (cli/visualize_attn.py).
    A forward pre-hook on each block, registered only here, records its
    detached inputs and leaves dispatch as it is; ``s_stage`` is off
    meanwhile, as JAX's _try_s_stage steps aside while intermediates are
    collected, so that every block runs and is seen."""
    inputs: List[Tuple[torch.Tensor, torch.Tensor]] = []
    hooks = [blk.register_forward_pre_hook(
        lambda mod, args: inputs.append((args[0].detach(), args[1].detach())))
        for stage in model.stages for blk in stage]
    s_stage, model.s_stage = model.s_stage, False
    try:
        yield inputs
    finally:
        model.s_stage = s_stage
        for h in hooks:
            h.remove()
