"""Multi-process bootstrap: counterpart of
lemevit_tpu/parallel/distributed.py, on ``torch.distributed``.

``init_distributed`` reads the torchrun-style environment (RANK /
WORLD_SIZE / MASTER_ADDR / MASTER_PORT / LOCAL_RANK) or SLURM's
(SLURM_PROCID / SLURM_NTASKS / SLURM_STEP_NODELIST / SLURM_LOCALID), with
the JAX package's defaults (address localhost, port 1234), and opens the
default process group: NCCL for a CUDA device, gloo for the CPU. With one
process it is a no-op. NCCL that fails to initialise raises; the run never
carries on over gloo instead.

The rest are the collectives of a data-parallel step whose random draws
are taken over the global batch (cli/train.py): every rank draws the
per-row values at the global shape from the same seeded generator and
keeps its own rows (``Shard.rows``), and mixup takes its partner rows from
the mirror rank (``Shard.mirror``, one send / recv pair), so that a W-rank
step on the W row blocks of a batch is the one-rank step on the whole
batch.
"""
from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, Optional

import torch
import torch.distributed as dist

DEFAULT_PORT = "1234"  # the JAX package's coordinator port


def _env_topology(env) -> dict:
    """(rank, world, local_rank, master address, port) from the torchrun
    or SLURM variables of ``env``; one process where neither is set."""
    if "RANK" in env:
        return dict(rank=int(env["RANK"]),
                    world=int(env.get("WORLD_SIZE", 1)),
                    local_rank=int(env.get("LOCAL_RANK", 0)),
                    addr=env.get("MASTER_ADDR", "localhost"),
                    port=env.get("MASTER_PORT", DEFAULT_PORT))
    if "SLURM_PROCID" in env:
        node = env.get("SLURM_STEP_NODELIST", "localhost").split(",")[0]
        return dict(rank=int(env["SLURM_PROCID"]),
                    world=int(env.get("SLURM_NTASKS", 1)),
                    local_rank=int(env.get("SLURM_LOCALID", 0)),
                    addr=node, port=DEFAULT_PORT)
    return dict(rank=0, world=1, local_rank=0, addr="localhost",
                port=DEFAULT_PORT)


def init_distributed(device: Any = "cuda", *, backend: Optional[str] = None,
                     timeout_s: float = 600.0, env=None) -> dict:
    """Open the default process group from the environment (see the module
    docstring) and return the JAX package's topology dict:
    {process_index, process_count, local_device_count,
    global_device_count, is_primary, local_rank, backend}.

    ``backend`` None takes NCCL on a CUDA ``device``, gloo on the CPU;
    "gloo" on CUDA tensors serves where NCCL cannot (two ranks on one
    card). With more than one process, each first sets its CUDA device to
    LOCAL_RANK. With one process, or where a group is already open,
    nothing is opened."""
    topo = _env_topology(os.environ if env is None else env)
    dev = torch.device(device)
    if dev.type == "cuda" and topo["world"] > 1:
        torch.cuda.set_device(topo["local_rank"])
    be = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if topo["world"] > 1 and not dist.is_initialized():
        dist.init_process_group(
            be, init_method=f"tcp://{topo['addr']}:{topo['port']}",
            rank=topo["rank"], world_size=topo["world"],
            timeout=timedelta(seconds=timeout_s))
    rank, world = process_index(), process_count()
    return {"process_index": rank, "process_count": world,
            "local_device_count": 1, "global_device_count": world,
            "is_primary": rank == 0, "local_rank": topo["local_rank"],
            "backend": dist.get_backend() if dist.is_initialized() else None}


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def group_active() -> bool:
    """Whether a process group of more than one rank is open: then
    BatchNorm reduces its statistics over it."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks (``t`` itself with one)."""
    if not group_active():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t / dist.get_world_size()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (``t`` itself with one)."""
    if not group_active():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the gradients over the
    ranks: each rank's output feeds its own loss, so the gradient of the
    sum of the ranks' losses with respect to one rank's input is the sum
    of their gradients with respect to the output."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, with the gradient running through
    the reduction (SyncBN's statistics)."""
    return _AllReduceSum.apply(t)


@dataclasses.dataclass(frozen=True)
class Shard:
    """Rank ``rank`` of ``world`` holds rows [rank b, (rank + 1) b) of a
    global batch of world b rows (the order in which the JAX package's
    ``make_array_from_process_local_data`` lays the processes' rows)."""
    rank: int = 0
    world: int = 1

    def rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of a tensor drawn at the global batch along
        ``dim``."""
        if self.world == 1:
            return t
        b = t.shape[dim] // self.world
        return t.narrow(dim, self.rank * b, b)

    def mirror(self, t: torch.Tensor) -> torch.Tensor:
        """The rows of rank world - 1 - rank, exchanged with that rank by
        one send / recv pair (through host memory over gloo): flipped,
        they are this rank's rows of the flipped global batch."""
        peer = self.world - 1 - self.rank
        if peer == self.rank:
            return t
        send = t.detach().contiguous()
        if dist.get_backend() == "gloo":
            send = send.cpu()
        recv = torch.empty_like(send)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, peer),
                dist.P2POp(dist.irecv, recv, peer)]):
            req.wait()
        return recv.to(t.device)
