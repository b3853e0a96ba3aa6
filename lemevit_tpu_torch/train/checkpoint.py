"""Checkpoint loading: counterpart of
lemevit_tpu/train/checkpoint.py::load_pretrained for torch checkpoints."""
from __future__ import annotations

import torch

from lemevit_tpu_torch.models.convert import strip_prefixes


def load_pretrained(model: torch.nn.Module, path: str,
                    use_ema: bool = False) -> torch.nn.Module:
    """Load a reference-named checkpoint (.pth / .pth.tar) into ``model``
    with ``strict=True``; with ``use_ema`` take its EMA weights. Training
    checkpoints pickle their arguments beside the weights, so the file is
    unpickled in full: load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if use_ema and isinstance(ckpt, dict) and "state_dict_ema" in ckpt:
        ckpt = {"state_dict": ckpt["state_dict_ema"]}
    sd = strip_prefixes(ckpt if isinstance(ckpt, dict) else ckpt.state_dict())
    model.load_state_dict(sd, strict=True)
    return model
