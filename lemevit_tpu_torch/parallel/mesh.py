"""Data x model process layout and the tensor-parallel rules: counterpart of
lemevit_tpu/parallel/mesh.py.

The port trains data-parallel: every rank holds the whole model (DDP), its
BatchNorms reduce their statistics over the process group
(core/layers.py::BatchNorm, JAX's ``axis_name="data"``), and the gradients
are averaged by DDP. ``MeshConfig`` / ``build_mesh`` lay the ranks out as
data x model, as JAX's mesh does; ``param_spec`` is JAX's ``_param_spec``
(the Megatron layout: qkv / q / kv / fc1 column-parallel, proj / fc2
row-parallel) on the port's parameter names, as a pure function. Running a
model axis above 1 (sharded linears and their collectives) is not ported
(ROADMAP queue 1, item 13); ``cli.train --mesh-model-axis`` refuses it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

TP_ITEM = "ROADMAP queue 1, item 13: tensor-parallel --mesh-model-axis"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1   # -1: every rank the model axis leaves
    model: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(f"mesh {data}x{model} != {n_devices} devices")
        return data, model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks as a (data, model) grid."""
    data: int
    model: int

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


def build_mesh(config: MeshConfig = MeshConfig(),
               n_devices: Optional[int] = None) -> Mesh:
    """The (data, model) grid over ``n_devices`` ranks (the process
    group's size by default)."""
    if n_devices is None:
        from lemevit_tpu_torch.parallel.distributed import process_count
        n_devices = process_count()
    return Mesh(*config.resolve(n_devices))


# JAX's substrings of a column-parallel kernel's path (mesh.py:67), on the
# port's names: qkv / qkv1 / qkv2 / qv1 / kv / kv2 / q of the attention
_COLUMN = re.compile(r"\.(?:qkv\d?|qv1|kv\d?|q)\.weight$")
_ROW = re.compile(r"\.(?:proj(?:_[xc])?)\.weight$")
# fc1 / fc2 of a block's Mlp (mlp.0 / mlp.3) and of a MetaTokenDownsample
# (meta_token_downsample.i.0 / .3)
_FC1 = re.compile(r"(?:^|\.)(?:mlp|meta_token_downsample\.\d+)\.0\.weight$")
_FC2 = re.compile(r"(?:^|\.)(?:mlp|meta_token_downsample\.\d+)\.3\.weight$")


def param_spec(name: str, ndim: int, model_axis_size: int
               ) -> Tuple[Optional[str], ...]:
    """JAX's ``_param_spec`` for the port parameter ``name`` of ``ndim``
    dimensions, in the port's (out, in) order: ("model", None) for a
    column-parallel weight, (None, "model") for a row-parallel one, ()
    where it is replicated (always at a model axis of 1; only 2-D weights
    shard)."""
    if model_axis_size <= 1 or ndim != 2:
        return ()
    if _COLUMN.search(name) or _FC1.search(name):
        return ("model", None)
    if _ROW.search(name) or _FC2.search(name):
        return (None, "model")
    return ()
