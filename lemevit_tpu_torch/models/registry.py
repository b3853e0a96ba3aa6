"""Model registry and factory (timm-style names): counterpart of
lemevit_tpu/models/registry.py, with the same variant hyperparameters.
All released variants use 16 meta tokens and head_dim 32. The
change-detection vertical's other backbones (resnet18 / 34 / 50,
swin_tiny; models/resnet.py, models/swin.py) are registered beside them,
as the JAX package registers them."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from lemevit_tpu_torch.core.layers import init_weights
from lemevit_tpu_torch.models import resnet, swin
from lemevit_tpu_torch.models.lemevit import LeMeViT

VARIANT_CFGS: Dict[str, Dict[str, Any]] = {
    "lemevit_tiny": dict(
        depth=(1, 2, 2, 8, 2), embed_dim=(64, 64, 128, 192, 320),
        head_dim=32, mlp_ratios=(4, 4, 4, 4, 4),
        attn_type=("C", "D", "D", "S", "S"), queries_len=16),
    "lemevit_small": dict(
        depth=(1, 2, 2, 6, 2), embed_dim=(96, 96, 192, 320, 384),
        head_dim=32, mlp_ratios=(4, 4, 4, 4, 4),
        attn_type=("C", "D", "D", "S", "S"), queries_len=16),
    "lemevit_base": dict(
        depth=(2, 4, 4, 18, 4), embed_dim=(96, 96, 192, 384, 512),
        head_dim=32, mlp_ratios=(4, 4, 4, 4, 4),
        attn_type=("C", "D", "D", "S", "S"), queries_len=16),
    "lemevit_small_v2": dict(
        depth=(1, 2, 2, 8, 2), embed_dim=(64, 64, 128, 256, 512),
        head_dim=32, mlp_ratios=(3, 3, 3, 3, 3),
        attn_type=("C", "D", "D", "S", "S"), queries_len=16),
    "lemevit_tiny_v2": dict(
        depth=(2, 2, 2, 4, 2), embed_dim=(96, 96, 192, 320, 384),
        head_dim=32, mlp_ratios=(4, 4, 4, 4, 4),
        attn_type=("C", "D2", "D2", "S", "S"), queries_len=16),
    "vit_tiny": dict(
        depth=(2, 2, 4, 2), embed_dim=(96, 192, 320, 384),
        head_dim=32, mlp_ratios=(4, 4, 4, 4),
        attn_type=("S", "S", "S", "S"), queries_len=16),
    # test/smoke-only micro config (not a reference variant)
    "lemevit_micro": dict(
        depth=(1, 1, 1, 1, 1), embed_dim=(16, 16, 32, 32, 32),
        head_dim=8, mlp_ratios=(2, 2, 2, 2, 2),
        attn_type=("C", "D", "D", "S", "S"), queries_len=4),
}


BACKBONES = {"resnet18": resnet.resnet18, "resnet34": resnet.resnet34,
             "resnet50": resnet.resnet50, "swin_tiny": swin.swin_tiny}


def list_models():
    """The LeMeViT variants (``variant_config`` takes each); the other
    backbones are in ``BACKBONES``."""
    return sorted(VARIANT_CFGS)


def variant_config(name: str) -> Dict[str, Any]:
    if name not in VARIANT_CFGS:
        raise KeyError(f"unknown model {name!r}; known: {list_models()} "
                       f"and {list(BACKBONES)}")
    return dict(VARIANT_CFGS[name])


def resolve_device(device: Optional[Any] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (the default) and absent, rather
    than carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; lemevit_tpu_torch runs on the GPU "
            "by default (pass device='cpu', or --device cpu, for the CPU)")
    return dev


def create_model(name: str, *, device: Optional[Any] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 **kwargs) -> LeMeViT:
    """create_model('lemevit_base', num_classes=1000): the named variant,
    initialised from ``torch.Generator().manual_seed(seed)`` (on the CPU, so
    every device gets the same weights) and moved to ``device`` (CUDA by
    default, see resolve_device) in ``dtype``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if name in BACKBONES:
        model = BACKBONES[name](**kwargs)
        (swin.init_swin if name.startswith("swin") else init_weights)(
            model, gen)
        return model.to(device=dev, dtype=dtype)
    cfg = variant_config(name)
    cfg.update(kwargs)
    model = LeMeViT(**cfg)
    init_weights(model, gen)
    return model.to(device=dev, dtype=dtype)
