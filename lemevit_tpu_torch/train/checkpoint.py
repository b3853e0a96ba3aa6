"""Checkpoints: counterpart of lemevit_tpu/train/checkpoint.py with
``torch.save`` in place of orbax.

  save_checkpoint(dir, state, metric, max_history)  checkpoint-<step>.pth,
      keeping the best ``max_history`` by metric (then by recency) in
      checkpoints.json
  save_recovery(dir, state)       one rolling mid-epoch slot, recovery.pth
  latest_checkpoint(dir)          the newest checkpoint-<step>.pth
  restore_checkpoint(path, state) model, optimizer, EMA and step
  auto_resume(dir, state)         the newer of the two
  load_pretrained(model, path)    reference-named .pth weights

A checkpoint holds the model's state_dict (parameters and BatchNorm
statistics, S sets each in an aug-splits run) under "state_dict", the EMA
model's under "state_dict_ema" (its parameters with the live statistics),
the optimizer's state (every rule's moments and buffers, and each group's
plateau scale) and the step,
so ``load_pretrained`` and ``cli/validate.py --checkpoint [--use-ema]``
read it as they read a reference checkpoint. ``restore_checkpoint`` reads
it with ``weights_only=True``.
"""
from __future__ import annotations

import json
import os
import re
from typing import Optional, Tuple

import torch

from lemevit_tpu_torch.models.convert import strip_prefixes
from lemevit_tpu_torch.train.state import TrainState

_CKPT = re.compile(r"checkpoint-(\d+)\.pth")


def _payload(state: TrainState) -> dict:
    sd = state.model.state_dict()
    out = {"state_dict": sd, "optimizer": state.optimizer.state_dict(),
           "step": state.step}
    if state.ema is not None:
        out["state_dict_ema"] = {**sd, **state.ema.state_dict()}
    return out


def _save(payload: dict, path: str) -> None:
    """Write through a temporary file, so a reader never sees half a
    checkpoint."""
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, state: TrainState, *,
                    metric: Optional[float] = None,
                    max_history: int = 3) -> str:
    """Save checkpoint-<step>.pth and keep the top ``max_history``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"checkpoint-{state.step}.pth")
    _save(_payload(state), path)
    meta_path = os.path.join(ckpt_dir, "checkpoints.json")
    meta = []
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = [m for m in json.load(f) if m["path"] != path]
    meta.append({"step": state.step, "metric": metric, "path": path})
    keep = sorted(meta, key=lambda m: (
        m["metric"] if m["metric"] is not None else -1e30, m["step"]),
        reverse=True)[:max_history]
    for m in meta:
        if m not in keep and os.path.exists(m["path"]):
            os.remove(m["path"])
    with open(meta_path, "w") as f:
        json.dump(keep, f, indent=1)
    return path


def save_recovery(ckpt_dir: str, state: TrainState) -> str:
    """Mid-epoch recovery checkpoint: one slot, overwritten by each save."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "recovery.pth")
    _save(_payload(state), path)
    with open(os.path.join(ckpt_dir, "recovery.json"), "w") as f:
        json.dump({"step": state.step}, f)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    found = [(int(m.group(1)), name) for name in os.listdir(ckpt_dir)
             if (m := _CKPT.fullmatch(name))]
    return os.path.join(ckpt_dir, max(found)[1]) if found else None


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint into ``state`` (in place) and return it."""
    dev = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    state.model.load_state_dict(ckpt["state_dict"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if state.ema is not None:
        if "state_dict_ema" not in ckpt:
            raise KeyError(f"{path} holds no EMA parameters")
        state.ema.load_state_dict(ckpt["state_dict_ema"])
    state.step = int(ckpt["step"])
    return state


def auto_resume(ckpt_dir: str, state: TrainState
                ) -> Tuple[TrainState, bool]:
    """Resume from the newer of the newest epoch checkpoint and the
    recovery slot; (state, False) when there is neither."""
    path = latest_checkpoint(ckpt_dir)
    best = int(_CKPT.search(path).group(1)) if path else -1
    rec_meta = os.path.join(ckpt_dir, "recovery.json")
    rec_path = os.path.join(ckpt_dir, "recovery.pth")
    if os.path.exists(rec_meta) and os.path.exists(rec_path):
        with open(rec_meta) as f:
            rec_step = int(json.load(f)["step"])
        if rec_step > best:
            path = rec_path
    if path is None:
        return state, False
    return restore_checkpoint(path, state), True


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
