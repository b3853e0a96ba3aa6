"""Checkpoint helpers for the PyTorch port.

The port's parameter names are the reference PyTorch checkpoint's, so a
reference ``.pth`` needs no converter: ``strip_prefixes`` unwraps it and
``load_state_dict(strict=True)`` takes it. ``from_jax_params`` turns the JAX
package's variables ({'params', 'batch_stats'}, as numpy arrays) into the
port's state_dict, so one set of weights can drive both packages; its logic
is that of lemevit_tpu/models/convert.py::flax_to_torch (conv HWIO -> OIHW,
dense (in, out) -> (out, in)).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def strip_prefixes(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Unwrap {state_dict|state_dict_ema|model} containers (in that order
    of preference, so plain weights win over EMA ones) and strip
    ``module.`` / ``backbone.`` prefixes."""
    for key in ("state_dict", "state_dict_ema", "model"):
        if key in sd and isinstance(sd[key], Mapping):
            sd = sd[key]
            break
    out = {}
    for k, v in sd.items():
        for pref in ("module.", "backbone."):
            if k.startswith(pref):
                k = k[len(pref):]
        out[k] = v
    return out


_ATTN_KEYS = {
    "S": ["qkv", "proj"],
    "C": ["q", "kv", "proj"],
    "D": ["qkv1", "qkv2", "proj_x", "proj_c"],
    "D2": ["qv1", "kv2", "proj_x", "proj_c"],
}


def from_jax_params(variables: Mapping[str, Any], model
                    ) -> Dict[str, torch.Tensor]:
    """State dict for ``model`` (a port LeMeViT) from JAX variables."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def get(tree, path):
        for p in path:
            tree = tree[p]
        return np.asarray(tree, dtype=np.float32)

    def put(key, arr):
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))

    def conv(dst, path):
        put(f"{dst}.weight", np.transpose(get(params, path + ["kernel"]),
                                          (3, 2, 0, 1)))
        put(f"{dst}.bias", get(params, path + ["bias"]))

    def bn(dst, path):
        put(f"{dst}.weight", get(params, path + ["scale"]))
        put(f"{dst}.bias", get(params, path + ["bias"]))
        put(f"{dst}.running_mean", get(stats, path + ["mean"]))
        put(f"{dst}.running_var", get(stats, path + ["var"]))
        sd[f"{dst}.num_batches_tracked"] = torch.tensor(0)

    def lin(dst, path):
        put(f"{dst}.weight", get(params, path + ["kernel"]).T)
        put(f"{dst}.bias", get(params, path + ["bias"]))

    def ln(dst, path):
        put(f"{dst}.weight", get(params, path + ["scale"]))
        put(f"{dst}.bias", get(params, path + ["bias"]))

    attn_types = list(model.attn_type)
    conv("downsample_layers.0.0", ["stem", "conv1", "conv"])
    bn("downsample_layers.0.1", ["stem", "conv1", "bn"])
    conv("downsample_layers.0.3", ["stem", "conv2", "conv"])
    bn("downsample_layers.0.4", ["stem", "conv2", "bn"])
    for i in range(1, len(attn_types)):
        if attn_types[i - 1] == "C":
            continue
        conv(f"downsample_layers.{i}.0", [f"downsample{i}", "conv"])
        bn(f"downsample_layers.{i}.1", [f"downsample{i}", "bn"])

    put("meta_tokens", get(params, ["meta_tokens"]))
    for i in range(len(attn_types)):
        dst, src = f"meta_token_downsample.{i}", f"meta_downsample{i}"
        lin(f"{dst}.0", [src, "fc1"])
        ln(f"{dst}.1", [src, "ln1"])
        lin(f"{dst}.3", [src, "fc2"])
        ln(f"{dst}.4", [src, "ln2"])

    for i, at in enumerate(attn_types):
        for j in range(model.depth[i]):
            dst, blk = f"stages.{i}.{j}", f"stage{i}_block{j}"
            tree = params[blk]
            if "pos_embed" in tree:
                conv(f"{dst}.pos_embed", [blk, "pos_embed", "dwconv"])
            ln(f"{dst}.norm1", [blk, "norm1"])
            ln(f"{dst}.norm2", [blk, "norm2"])
            for ak in _ATTN_KEYS[at]:
                lin(f"{dst}.attn.{ak}", [blk, "attn", ak])
            lin(f"{dst}.mlp.0", [blk, "mlp", "fc1"])
            if "dwconv" in tree["mlp"]:
                conv(f"{dst}.mlp.1", [blk, "mlp", "dwconv", "dwconv"])
            lin(f"{dst}.mlp.3", [blk, "mlp", "fc2"])
            for g in ("gamma1", "gamma2"):
                if g in tree:
                    put(f"{dst}.{g}", get(params, [blk, g]).reshape(-1))

    if not model.features_only:
        bn("norm", ["norm"])
        ln("norm_c", ["norm_c"])
        if "head" in params:
            lin("head", ["head"])
    return sd
