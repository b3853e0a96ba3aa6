"""PyTorch port, multi-process training (parallel/, SyncBN, DDP through
cli.train) on the CPU:
  - init_distributed's environment parsing (torchrun and SLURM), with no
    process group opened for one process;
  - MeshConfig / build_mesh and the tensor-parallel rules
    (parallel/mesh.py::param_spec) against JAX's _param_spec on
    lemevit_micro, each JAX leaf followed to its port name through
    models/convert.py; cli.train refusing --mesh-model-axis 2;
  - one two-process gloo job (tests/torch_parallel_worker.py, its own
    free port and a 60 s limit): SyncBN on half a batch per rank against
    flax's BatchNorm on the whole batch (output, running statistics,
    input / weight / bias gradients at 1e-5, plain and with 3 splits); two
    train steps of lemevit_micro with erasing, mixup / cutmix and DropPath
    on halves A | B against one rank on A||B (losses 2e-4, parameters
    5e-3); cli.train at --grad-accum-steps 1 and 2 against one process at
    twice the batch (per-step losses 2e-4), only rank 0 writing, its
    checkpoint restoring in a one-process cli.validate, and both ranks
    resuming a one-process checkpoint.
All fp32."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from lemevit_tpu.models import create_model as j_create_model
from lemevit_tpu.parallel import mesh as jmesh
from lemevit_tpu.parallel.distributed import init_distributed as j_init
from lemevit_tpu_torch.cli import train, validate
from lemevit_tpu_torch.models.convert import from_jax_params
from lemevit_tpu_torch.models.registry import create_model
from lemevit_tpu_torch.parallel import (MeshConfig, Shard, build_mesh,
                                        init_distributed, param_spec)
from lemevit_tpu_torch.parallel.distributed import _env_topology
from tests.torch_parallel_worker import (NUM_CLASSES, STEPS, cli_args,
                                         run_steps)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BN_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
PARAM_TOL = dict(rtol=5e-3, atol=5e-3)
WORLD, SPLITS, C = 2, 3, 6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for these micro sizes: with several test
    workers on the machine, a pool per worker as wide as the machine
    spends its time waiting on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- topology

@pytest.mark.parametrize("env,want", [
    ({}, dict(rank=0, world=1, local_rank=0, addr="localhost",
              port="1234")),
    ({"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
      "MASTER_ADDR": "node7", "MASTER_PORT": "2950"},
     dict(rank=3, world=4, local_rank=1, addr="node7", port="2950")),
    ({"RANK": "0"}, dict(rank=0, world=1, local_rank=0, addr="localhost",
                         port="1234")),
    ({"SLURM_PROCID": "5", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1",
      "SLURM_STEP_NODELIST": "gpu12,gpu13"},
     dict(rank=5, world=8, local_rank=1, addr="gpu12", port="1234"))],
    ids=["none", "torchrun", "rank-only", "slurm"])
def test_env_topology(env, want):
    assert _env_topology(env) == want


def test_init_distributed_one_process_is_a_no_op():
    got = init_distributed("cpu", env={"RANK": "0", "WORLD_SIZE": "1"})
    assert not torch.distributed.is_initialized()
    assert got["process_index"] == 0 and got["process_count"] == 1
    assert got["is_primary"] and got["backend"] is None
    want = j_init()  # JAX's keys (its device counts are its own)
    assert set(want) <= set(got)


def test_row_noise_depends_on_its_seed_alone():
    """The erasing noise of a global row is the same whichever rank draws
    it, beside whichever rows."""
    from lemevit_tpu_torch.data.mixup import row_noise
    seeds = torch.from_numpy(np.random.default_rng(0).integers(2 ** 63,
                                                                size=6))
    whole = row_noise(seeds, (4, 5, 3), "cpu")
    assert whole.shape == (6, 4, 5, 3) and whole.dtype == torch.float32
    for rank in range(3):
        shard = Shard(rank, 3)
        assert torch.equal(row_noise(shard.rows(seeds), (4, 5, 3), "cpu"),
                           shard.rows(whole))
    assert not torch.equal(whole[0], whole[1])


def test_mesh_resolve():
    assert build_mesh(MeshConfig(), 8).shape == {"data": 8, "model": 1}
    m = build_mesh(MeshConfig(data=4, model=2), 8)
    assert m.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        build_mesh(MeshConfig(data=3, model=2), 8)
    assert build_mesh(MeshConfig(model=2), 8).data == 4
    for cfg in (MeshConfig(), MeshConfig(data=2, model=4)):
        assert cfg.resolve(8) == jmesh.MeshConfig(cfg.data,
                                                  cfg.model).resolve(8)


def test_param_specs_match_jax_param_spec():
    """Every port parameter of lemevit_micro is column- or row-parallel,
    or replicated, where JAX's _param_spec puts the leaf it comes from
    (JAX's kernels are (in, out), the port's weights (out, in))."""
    jm = j_create_model("lemevit_micro", num_classes=10, attn_backend="xla")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes["params"])
    transposed = {(): (), (None, "model"): ("model", None),
                  ("model", None): (None, "model")}
    jax_spec = [transposed[tuple(jmesh._param_spec(path, leaf, 2))]
                for path, leaf in leaves]
    tagged = jax.tree_util.tree_unflatten(tree, [
        np.full(leaf.shape, i, np.float32)
        for i, (_, leaf) in enumerate(leaves)])
    stats = jax.tree.map(lambda s: np.full(s.shape, -1.0, np.float32),
                         shapes["batch_stats"])
    tm = create_model("lemevit_micro", num_classes=10, device="cpu")
    sd = from_jax_params({"params": tagged, "batch_stats": stats}, tm)
    seen = []
    for name, p in tm.named_parameters():
        i = int(sd[name].flatten()[0])
        assert (sd[name] == i).all(), name
        want = jax_spec[i] if leaves[i][1].ndim == p.dim() else ()
        assert param_spec(name, p.dim(), 2) == want, name
        assert param_spec(name, p.dim(), 1) == ()
        seen.append(want)
    assert ("model", None) in seen and (None, "model") in seen


def test_mesh_model_axis_above_one_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="item 13"):
        train.main(cli_args(1, str(tmp_path), 2) + ["--mesh-model-axis",
                                                    "2"])
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------- 2 ranks

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inputs(rng):
    inp = {"bn_w": 1 + 0.3 * rng.randn(C), "bn_b": 0.2 * rng.randn(C)}
    for mode, s in (("plain", 1), ("split", SPLITS)):
        shape = (s, 4, C, 5, 3)
        inp[f"bn_{mode}_x"] = 2 + 3 * rng.randn(*shape)
        inp[f"bn_{mode}_g"] = rng.randn(*shape)
        stat = (C,) if s == 1 else (s, C)
        inp[f"bn_{mode}_rm"] = 0.5 * rng.randn(*stat)
        inp[f"bn_{mode}_rv"] = 1 + rng.rand(*stat)
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    inp["images"] = rng.randint(0, 256, (STEPS, 4, 32, 32, 3), np.uint8)
    inp["labels"] = rng.randint(0, NUM_CLASSES, (STEPS, 4)).astype(np.int64)
    return inp


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Runs the two-rank job once; (inputs, [rank 0, rank 1] results,
    its directory)."""
    out = tmp_path_factory.mktemp("ranks")
    inp = _inputs(np.random.RandomState(0))
    np.savez(out / "inputs.npz", **inp)
    # a one-process checkpoint (2 steps at twice the batch) for the ranks
    # to resume
    train.main(cli_args(1, str(out / "one_pre"), batch=4))
    ckpt = json.load(open(out / "one_pre" / "lemevit_micro" / "checkpoints"
                          / "checkpoints.json"))[0]["path"]
    (out / "resume_from.txt").write_text(ckpt)
    port = _free_port()
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(WORLD),
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_worker", str(out)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=60)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return inp, [dict(np.load(out / f"rank{r}.npz")) for r in
                 range(WORLD)], out


def _flax_bn(x_nchw, g_nchw, w, b, rm, rv):
    """flax BatchNorm (train mode, momentum 0.9, eps 1e-5) on the whole
    batch: output, d sum(y g) / d (x, scale, bias), updated statistics."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    x = jnp.asarray(x_nchw).transpose(0, 2, 3, 1)
    g = jnp.asarray(g_nchw).transpose(0, 2, 3, 1)

    def f(x, scale, bias):
        y, mut = bn.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": {"mean": rm, "var": rv}}, x,
                          mutable=["batch_stats"])
        return (y * g).sum(), (y, mut["batch_stats"])

    (_, (y, st)), (dx, dw, db) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(x, w, b)
    t = (0, 3, 1, 2)
    return (np.asarray(y.transpose(t)), np.asarray(dx.transpose(t)),
            np.asarray(dw), np.asarray(db), np.asarray(st["mean"]),
            np.asarray(st["var"]))


@pytest.mark.parametrize("mode", ["plain", "split"])
def test_syncbn_matches_flax_on_the_global_batch(two_ranks, mode):
    inp, ranks, _ = two_ranks
    x, g = inp[f"bn_{mode}_x"], inp[f"bn_{mode}_g"]
    s, gb = x.shape[:2]
    b = gb // WORLD
    for si in range(s):
        rm, rv = inp[f"bn_{mode}_rm"], inp[f"bn_{mode}_rv"]
        if s > 1:
            rm, rv = rm[si], rv[si]
        y, dx, dw, db, m, v = _flax_bn(x[si], g[si], inp["bn_w"],
                                       inp["bn_b"], rm, rv)
        for r, res in enumerate(ranks):
            rows = slice(r * b, (r + 1) * b)
            got_y = res[f"{mode}_y"].reshape(s, b, *x.shape[2:])[si]
            got_dx = res[f"{mode}_dx"].reshape(s, b, *x.shape[2:])[si]
            np.testing.assert_allclose(got_y, y[rows], **BN_TOL)
            np.testing.assert_allclose(got_dx, dx[rows], **BN_TOL)
            got_m, got_v = res[f"{mode}_rm"], res[f"{mode}_rv"]
            if s > 1:
                got_m, got_v = got_m[si], got_v[si]
            np.testing.assert_allclose(got_m, m, **BN_TOL)
            np.testing.assert_allclose(got_v, v, **BN_TOL)
    # the weight and bias gradients sum over the splits
    for r, res in enumerate(ranks):
        want = [_flax_bn(x[si], g[si], inp["bn_w"], inp["bn_b"],
                         np.zeros(C, np.float32), np.ones(C, np.float32))
                for si in range(s)]
        np.testing.assert_allclose(res[f"{mode}_dw"],
                                   sum(w[2] for w in want), **BN_TOL)
        np.testing.assert_allclose(res[f"{mode}_db"],
                                   sum(w[3] for w in want), **BN_TOL)


def test_two_rank_step_equals_one_rank_step(two_ranks):
    """Erasing, mixup and cutmix (both drawn in the two steps), DropPath:
    the two ranks' steps on A | B are the one-rank steps on A||B."""
    inp, ranks, _ = two_ranks
    from lemevit_tpu_torch.cli.train import step_generators
    from lemevit_tpu_torch.data.mixup import draw_mixup
    from tests.torch_parallel_worker import SEED
    modes = {draw_mixup(step_generators(SEED, s, torch.Generator()), 32, 32,
                        mixup_alpha=0.8, cutmix_alpha=1.0).mode
             for s in range(STEPS)}
    assert modes == {"mixup", "cutmix"}
    one = run_steps(inp, Shard(0, 1))
    for res in ranks:
        np.testing.assert_allclose(res["step_losses"], one["step_losses"],
                                   **LOSS_TOL)
        np.testing.assert_allclose(res["step_gnorms"], one["step_gnorms"],
                                   **PARAM_TOL)
        keys = [k for k in one if k.startswith("p:")]
        assert keys and set(keys) == {k for k in res if k.startswith("p:")}
        for k in keys:
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(res[k], one[k], err_msg=k,
                                           **PARAM_TOL)


def _events(run):
    path = os.path.join(run, "lemevit_micro", "events.jsonl")
    return [json.loads(line) for line in open(path)]


@pytest.mark.parametrize("accum", [1, 2])
def test_two_process_cli_train_equals_one_process(two_ranks, tmp_path,
                                                  accum):
    _, ranks, out = two_ranks
    assert all(int(res[f"cli{accum}_processes"]) == WORLD for res in ranks)
    rank0, rank1 = (out / f"cli{accum}" / f"r{r}" for r in range(WORLD))
    assert not rank1.exists()  # rank 1 wrote nothing
    files = set(os.listdir(rank0 / "lemevit_micro"))
    assert {"events.jsonl", "summary.csv", "train.log",
            "checkpoints"} <= files
    one = train.main(cli_args(accum, str(tmp_path / "one"), batch=4))
    assert one["processes"] == 1
    got, want = _events(str(rank0)), _events(str(tmp_path / "one"))
    assert [e["step"] for e in got] == [e["step"] for e in want]
    np.testing.assert_allclose([e["loss"] for e in got],
                               [e["loss"] for e in want], **LOSS_TOL)
    np.testing.assert_allclose([e["lr"] for e in got],
                               [e["lr"] for e in want], rtol=1e-9)
    ckpt = json.load(open(rank0 / "lemevit_micro" / "checkpoints"
                          / "checkpoints.json"))[0]["path"]
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert not any(k.startswith("module.") for k in sd["state_dict"])
    res = validate.main(["--synthetic", "--model", "lemevit_micro",
                         "--img-size", "32", "--num-classes", "10",
                         "--batch-size", "4", "--device", "cpu",
                         "--checkpoint", ckpt, "--workers", "1"])
    assert np.isfinite(res["top1"])


def test_two_ranks_resume_a_one_process_checkpoint(two_ranks):
    """A checkpoint written by one process restores in two: both ranks
    resume at step 2 and run the second epoch's 2 steps; only rank 0
    writes."""
    _, ranks, out = two_ranks
    assert [int(res["resume_steps"]) for res in ranks] == [4, 4]
    assert not (out / "resume" / "r1").exists()
    assert [e["step"] for e in _events(str(out / "resume" / "r0"))] == [3, 4]
