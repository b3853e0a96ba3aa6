"""Checkpoint helpers for the PyTorch port.

The port's parameter names are the reference PyTorch checkpoint's, so a
reference ``.pth`` needs no converter: ``strip_prefixes`` unwraps it and
``load_state_dict(strict=True)`` takes it. ``from_jax_params`` turns the JAX
package's variables ({'params', 'batch_stats'}, as numpy arrays) into the
port's state_dict, so one set of weights can drive both packages; its logic
is that of lemevit_tpu/models/convert.py::flax_to_torch (conv HWIO -> OIHW,
dense (in, out) -> (out, in)). ``from_jax_upernet`` does the same for the
JAX UperNet (tasks/upernet.py), ``from_jax_backbone`` for the ResNet and
Swin backbones, ``from_jax_cd`` for the change-detection models
(tasks/change_detection.py, tasks/snunet.py), ``from_jax_det`` for the
oriented detector (tasks/detection.py), ``from_jax_maskrcnn`` for Mask
R-CNN (tasks/mask_rcnn.py) and ``from_jax_plugin`` for the plugin layers
(ops/plugins.py).
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


class _Writer:
    """Puts JAX arrays into a port state_dict under port names: conv HWIO
    -> OIHW, dense (in, out) -> (out, in), flax BatchNorm's scale / bias /
    mean / var -> weight / bias / running_mean / running_var."""

    def __init__(self, params, stats):
        self.params, self.stats = params, stats
        self.sd: Dict[str, torch.Tensor] = {}

    @staticmethod
    def get(tree, path):
        for p in path:
            tree = tree[p]
        return np.asarray(tree, dtype=np.float32)

    def put(self, key, arr):
        self.sd[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))

    def conv(self, dst, path, bias=True):
        self.put(f"{dst}.weight", np.transpose(
            self.get(self.params, path + ["kernel"]), (3, 2, 0, 1)))
        if bias:
            self.put(f"{dst}.bias", self.get(self.params, path + ["bias"]))

    def bn(self, dst, path):
        self.put(f"{dst}.weight", self.get(self.params, path + ["scale"]))
        self.put(f"{dst}.bias", self.get(self.params, path + ["bias"]))
        self.put(f"{dst}.running_mean", self.get(self.stats, path + ["mean"]))
        self.put(f"{dst}.running_var", self.get(self.stats, path + ["var"]))
        self.sd[f"{dst}.num_batches_tracked"] = torch.tensor(0)

    def lin(self, dst, path):
        self.put(f"{dst}.weight", self.get(self.params, path + ["kernel"]).T)
        self.put(f"{dst}.bias", self.get(self.params, path + ["bias"]))

    def ln(self, dst, path):
        self.put(f"{dst}.weight", self.get(self.params, path + ["scale"]))
        self.put(f"{dst}.bias", self.get(self.params, path + ["bias"]))


def from_jax_params(variables: Mapping[str, Any], model
                    ) -> Dict[str, torch.Tensor]:
    """State dict for ``model`` (a port LeMeViT) from JAX variables."""
    params = variables["params"]
    w = _Writer(params, variables.get("batch_stats", {}))
    attn_types = list(model.attn_type)
    w.conv("downsample_layers.0.0", ["stem", "conv1", "conv"])
    w.bn("downsample_layers.0.1", ["stem", "conv1", "bn"])
    w.conv("downsample_layers.0.3", ["stem", "conv2", "conv"])
    w.bn("downsample_layers.0.4", ["stem", "conv2", "bn"])
    for i in range(1, len(attn_types)):
        if attn_types[i - 1] == "C":
            continue
        w.conv(f"downsample_layers.{i}.0", [f"downsample{i}", "conv"])
        w.bn(f"downsample_layers.{i}.1", [f"downsample{i}", "bn"])

    w.put("meta_tokens", w.get(params, ["meta_tokens"]))
    for i in range(len(attn_types)):
        dst, src = f"meta_token_downsample.{i}", f"meta_downsample{i}"
        w.lin(f"{dst}.0", [src, "fc1"])
        w.ln(f"{dst}.1", [src, "ln1"])
        w.lin(f"{dst}.3", [src, "fc2"])
        w.ln(f"{dst}.4", [src, "ln2"])

    for i, at in enumerate(attn_types):
        for j in range(model.depth[i]):
            dst, blk = f"stages.{i}.{j}", f"stage{i}_block{j}"
            tree = params[blk]
            if "pos_embed" in tree:
                w.conv(f"{dst}.pos_embed", [blk, "pos_embed", "dwconv"])
            w.ln(f"{dst}.norm1", [blk, "norm1"])
            w.ln(f"{dst}.norm2", [blk, "norm2"])
            for ak in _ATTN_KEYS[at]:
                w.lin(f"{dst}.attn.{ak}", [blk, "attn", ak])
            w.lin(f"{dst}.mlp.0", [blk, "mlp", "fc1"])
            if "dwconv" in tree["mlp"]:
                w.conv(f"{dst}.mlp.1", [blk, "mlp", "dwconv", "dwconv"])
            w.lin(f"{dst}.mlp.3", [blk, "mlp", "fc2"])
            for g in ("gamma1", "gamma2"):
                if g in tree:
                    w.put(f"{dst}.{g}", w.get(params, [blk, g]).reshape(-1))

    if not model.features_only:
        w.bn("norm", ["norm"])
        w.ln("norm_c", ["norm_c"])
        if "head" in params:
            w.lin("head", ["head"])
    return w.sd


def from_jax_upernet(variables: Mapping[str, Any], model
                     ) -> Dict[str, torch.Tensor]:
    """State dict for ``model`` (a port tasks.upernet.UperNet) from the
    JAX UperNet's variables, module names as the JAX package's: the
    backbone under ``backbone.``, ``decode_head`` (ppm/pool{i},
    bottleneck, lateral{i}, fpn{i}, fuse, seg) and ``aux_head`` (conv{i},
    seg)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = {f"backbone.{k}": v for k, v in from_jax_params(
        {"params": params["backbone"],
         "batch_stats": stats.get("backbone", {})}, model.backbone).items()}
    w = _Writer(params, stats)

    def conv_module(dst, path):
        w.conv(f"{dst}.conv", path + ["conv"], bias=False)
        w.bn(f"{dst}.bn", path + ["bn"])

    head = model.decode_head
    for i in range(len(head.ppm.pool_scales)):
        conv_module(f"decode_head.ppm.pool{i}",
                    ["decode_head", "ppm", f"pool{i}"])
    conv_module("decode_head.bottleneck", ["decode_head", "bottleneck"])
    for i in range(head.levels - 1):
        conv_module(f"decode_head.lateral{i}", ["decode_head", f"lateral{i}"])
        conv_module(f"decode_head.fpn{i}", ["decode_head", f"fpn{i}"])
    conv_module("decode_head.fuse", ["decode_head", "fuse"])
    w.conv("decode_head.seg", ["decode_head", "seg"])
    for i in range(model.aux_head.num_convs):
        conv_module(f"aux_head.conv{i}", ["aux_head", f"conv{i}"])
    w.conv("aux_head.seg", ["aux_head", "seg"])
    return {**sd, **w.sd}


def _from_tree(params: Mapping[str, Any], stats: Mapping[str, Any],
               rename=lambda k: k, prefix: str = ""
               ) -> Dict[str, torch.Tensor]:
    """A state dict from a JAX variable tree whose module names are the
    port's (up to ``rename`` of the dotted path): kernels of 4 dims are
    convolutions (HWIO -> OIHW; flax's ConvTranspose kernels too, the
    port applying them unflipped), of 2 dims Dense (in, out) -> (out, in);
    ``scale`` -> ``weight``; a module with BatchNorm statistics in
    ``stats`` gets ``running_mean`` / ``running_var``; other arrays
    (pos_embed, rel_pos_bias) keep their names and shapes."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        sd[rename(prefix + key)] = torch.from_numpy(
            np.array(arr, np.float32, order="C"))

    def walk(p, s, path):
        for k, v in p.items():
            key = f"{path}{k}"
            if isinstance(v, Mapping):
                walk(v, s.get(k, {}) if isinstance(s, Mapping) else {},
                     key + ".")
                continue
            a = np.asarray(v, dtype=np.float32)
            if k == "kernel":
                put(f"{path}weight", np.transpose(a, (3, 2, 0, 1))
                    if a.ndim == 4 else a.T)
            elif k == "scale":
                put(f"{path}weight", a)
            else:
                put(key, a)
        if isinstance(s, Mapping) and "mean" in s and "var" in s:
            put(f"{path}running_mean", np.asarray(s["mean"]))
            put(f"{path}running_var", np.asarray(s["var"]))
            sd[rename(f"{prefix}{path}num_batches_tracked")] = torch.tensor(0)

    walk(params, stats, "")
    return sd


def _swin_name(k: str) -> str:
    return k.replace(".mlp.fc1.", ".mlp.0.").replace(".mlp.fc2.", ".mlp.3.")


def _diff_name(k: str) -> str:
    """SiamUnetDiff's encoder stages: enc{i}.conv{k} -> enc{i}_conv{k}."""
    parts = k.split(".")
    if parts[0].startswith("enc") and len(parts) > 2:
        return f"{parts[0]}_{parts[1]}." + ".".join(parts[2:])
    return k


def from_jax_backbone(variables: Mapping[str, Any], model
                      ) -> Dict[str, torch.Tensor]:
    """State dict for a port backbone (LeMeViT, ResNet or Swin) from the
    JAX backbone's variables."""
    from lemevit_tpu_torch.models.lemevit import LeMeViT
    from lemevit_tpu_torch.models.swin import SwinTransformer
    if isinstance(model, LeMeViT):
        return from_jax_params(variables, model)
    return _from_tree(variables["params"], variables.get("batch_stats", {}),
                      _swin_name if isinstance(model, SwinTransformer)
                      else (lambda k: k))


def from_jax_cd(variables: Mapping[str, Any], model
                ) -> Dict[str, torch.Tensor]:
    """State dict for a port change-detection model from the JAX model's
    variables, BatchNorm statistics included: BIT over a LeMeViT, ResNet
    or Swin backbone (``backbone.`` + from_jax_backbone, ``bit_head.``),
    SNUNetECAM, SiamNestedUNetConc and SiamUnetDiff."""
    from lemevit_tpu_torch.tasks.change_detection import BITChangeDetector
    from lemevit_tpu_torch.tasks.snunet import SiamUnetDiff
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    if isinstance(model, BITChangeDetector):
        sd = {f"backbone.{k}": v for k, v in from_jax_backbone(
            {"params": params["backbone"],
             "batch_stats": stats.get("backbone", {})},
            model.backbone).items()}
        sd.update(_from_tree(params["bit_head"], {}, prefix="bit_head."))
        return sd
    return _from_tree(params, stats, _diff_name
                      if isinstance(model, SiamUnetDiff) else (lambda k: k))


def from_jax_det(variables: Mapping[str, Any], model
                 ) -> Dict[str, torch.Tensor]:
    """State dict for a port tasks.detection.OrientedRCNN from the JAX
    OrientedRCNN's variables: the backbone's (``backbone.``, its BatchNorm
    statistics included) by from_jax_backbone, ``neck``, ``rpn`` and
    ``roi_head`` by name (conv HWIO -> OIHW, Dense kernels transposed)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = {f"backbone.{k}": v for k, v in from_jax_backbone(
        {"params": params["backbone"],
         "batch_stats": stats.get("backbone", {})}, model.backbone).items()}
    for head in ("neck", "rpn", "roi_head"):
        sd.update(_from_tree(params[head], stats.get(head, {}),
                             prefix=f"{head}."))
    return sd


def from_jax_maskrcnn(variables: Mapping[str, Any], model
                      ) -> Dict[str, torch.Tensor]:
    """State dict for a port tasks.mask_rcnn.MaskRCNN from the JAX
    MaskRCNN's variables: the backbone's (``backbone.``, BatchNorm
    statistics included) by from_jax_backbone; ``neck``, ``rpn``,
    ``box_head`` and ``mask_head`` by name. The mask head's 2x2
    ConvTranspose kernel (HWIO, applied unflipped) becomes the OIHW weight
    that tasks/snunet.conv_transpose_same correlates with."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = {f"backbone.{k}": v for k, v in from_jax_backbone(
        {"params": params["backbone"],
         "batch_stats": stats.get("backbone", {})}, model.backbone).items()}
    for head in ("neck", "rpn", "box_head", "mask_head"):
        sd.update(_from_tree(params[head], stats.get(head, {}),
                             prefix=f"{head}."))
    return sd


def from_jax_plugin(variables: Mapping[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """State dict for a port plugin layer (ops/plugins.py: ContextBlock,
    NonLocal2D, GeneralizedAttention, SumCell, GlobalPoolingCell) from
    the JAX module's variables; the names are the JAX package's
    (LayerNorm and BatchNorm ``scale`` -> ``weight``, the BatchNorm's
    statistics -> ``running_mean`` / ``running_var``)."""
    return _from_tree(variables["params"], variables.get("batch_stats", {}))
