"""PyTorch port, the rest of the optimizer factory on the CPU, against the
JAX package's optax chains on the same gradients:
  - every --opt name (adamw, adam, sgd, momentum, nesterov, rmsprop,
    rmsproptf, lamb, adagrad; the SGD names also at momentum 0) over five
    updates of a small parameter set (a 2-D weight, a 1-D bias, meta
    tokens, a frozen tensor) under a warmup-into-cosine LR, weight decay
    0.05 and an active clip, with grad_accum_steps 1 and 2 (optax's
    MultiSteps), through the train step's apply_gradients;
  - torch.optim.RMSprop / Adagrad on the same inputs, which must not match
    (eps outside the root, the LR after the momentum, a zero start);
  - PlateauController against JAX's over metric sequences (max, min,
    cooldown); the plateau scale set mid-run against set_plateau_scale on
    JAX's MultiSteps state; a checkpoint that keeps the scale and the
    optimizer state;
  - mm_step_schedule and build_lr_schedule(sched="plateau"), value for
    value.
Tolerances: the parameters rtol = atol = 1e-6 in fp32 (the same chain of
fp32 operations in a different order); the schedules rtol 1e-6."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from lemevit_tpu.train import optim as joptim
from lemevit_tpu_torch.train import checkpoint as ckpt
from lemevit_tpu_torch.train import optim as toptim
from lemevit_tpu_torch.train.state import TrainState
from lemevit_tpu_torch.train.steps import apply_gradients

TOL = dict(rtol=1e-6, atol=1e-6)
WD = 0.05
CLIP = 2.0
UPDATES = 5
# warmup over the first two updates, cosine over the rest
SCHED = dict(base_lr=0.02, global_batch_size=512, steps_per_epoch=2,
             epochs=5, warmup_epochs=1, warmup_lr=1e-3, min_lr=1e-4)
# port name -> (JAX path, transpose): the Net's parameters as JAX leaves
LEAVES = {"fc.weight": (("fc", "kernel"), True),
          "fc.bias": (("fc", "bias"), False),
          "meta_tokens": (("meta_tokens",), False),
          "frozen.weight": (("frozen", "kernel"), True)}


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(5, 3)
        self.meta_tokens = torch.nn.Parameter(torch.zeros(4, 5))
        self.frozen = torch.nn.Linear(3, 2, bias=False)


def _to_jax(named):
    tree = {}
    for name, arr in named.items():
        path, tr = LEAVES[name]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(arr.T if tr else arr, jnp.float32)
    return tree


def _from_jax(tree, name):
    path, tr = LEAVES[name]
    for key in path:
        tree = tree[key]
    a = np.asarray(tree)
    return a.T if tr else a


def _inputs(steps, seed=0):
    """Initial values and ``steps`` micro-steps of gradients, numpy fp32;
    the gradients grow, so the clip acts on the later steps only."""
    rng = np.random.RandomState(seed)
    shapes = {"fc.weight": (3, 5), "fc.bias": (3,), "meta_tokens": (4, 5),
              "frozen.weight": (2, 3)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * (0.2 + 0.3 * i)).astype(np.float32)
              for k, s in shapes.items()} for i in range(steps)]
    return init, grads


def run_port(opt, k, init, grads, momentum=0.9, scale_at=None, scale=0.5,
             net=None):
    """The port's optimizer through apply_gradients; ``scale`` set before
    micro-step ``scale_at``. Returns the final values and the state."""
    net = net or Net()
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(torch.from_numpy(init[name]))
    state = TrainState(net, toptim.build_optimizer(
        net, weight_decay=WD, frozen_prefixes=("frozen",), opt=opt,
        momentum=momentum), toptim.build_lr_schedule(**SCHED),
        grad_accum_steps=k, clip_grad=CLIP)
    params = list(net.parameters())
    names = [n for n, _ in net.named_parameters()]
    for i, g in enumerate(grads):
        if i == scale_at:
            toptim.set_plateau_scale(state.optimizer, scale)
        apply_gradients(state, params,
                        [torch.from_numpy(g[n].copy()) for n in names])
    return {n: p.detach().numpy() for n, p in net.named_parameters()}, state


def run_jax(opt, k, init, grads, momentum=0.9, scale_at=None, scale=0.5):
    """The JAX package's build_optimizer (optax) on the same gradients."""
    params = _to_jax(init)
    tx = joptim.build_optimizer(
        joptim.build_lr_schedule(**SCHED), weight_decay=WD, clip_grad=CLIP,
        grad_accum_steps=k, frozen_prefixes=("frozen",),
        params_example=params, opt=opt, momentum=momentum,
        plateau=scale_at is not None)
    st = tx.init(params)

    @jax.jit
    def step(g, st, params):
        upd, st = tx.update(g, st, params)
        return optax.apply_updates(params, upd), st

    for i, g in enumerate(grads):
        if i == scale_at:
            st = joptim.set_plateau_scale(st, scale)
        params, st = step(_to_jax(g), st, params)
    return {n: _from_jax(params, n) for n in LEAVES}


def assert_close(got, want, msg=""):
    for name in LEAVES:
        np.testing.assert_allclose(got[name], want[name], **TOL,
                                   err_msg=f"{msg} {name}")


CASES = ([(opt, k, 0.9) for opt in toptim.OPTIMIZERS for k in (1, 2)]
         + [(opt, 1, 0.0) for opt in ("sgd", "nesterov", "momentum")])


@pytest.mark.parametrize("opt,k,momentum", CASES,
                         ids=[f"{o}-accum{k}-m{m}" for o, k, m in CASES])
def test_optimizer_matches_optax(opt, k, momentum):
    init, grads = _inputs(UPDATES * k)
    got, state = run_port(opt, k, init, grads, momentum)
    assert state.updates == UPDATES
    want = run_jax(opt, k, init, grads, momentum)
    assert_close(got, want, opt)
    np.testing.assert_array_equal(got["frozen.weight"],
                                  init["frozen.weight"])
    # the run moved every unfrozen tensor well past the tolerance
    for name in ("fc.weight", "fc.bias", "meta_tokens"):
        assert np.abs(got[name] - init[name]).max() > 1e-3, name


@pytest.mark.parametrize("opt,cls,kw", [
    ("rmsprop", torch.optim.RMSprop, dict(alpha=0.9, eps=1e-8,
                                          momentum=0.9)),
    ("adagrad", torch.optim.Adagrad, dict(eps=1e-8))], ids=["rmsprop",
                                                              "adagrad"])
def test_torch_classes_differ_from_optax(opt, cls, kw):
    """The torch class of the same name, given the port's groups, leaves
    optax's result by far more than the tolerance: the parity above holds
    only with the port's own rules."""
    init, grads = _inputs(UPDATES)
    want = run_jax(opt, 1, init, grads)
    net = Net()
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(torch.from_numpy(init[name]))
    groups = toptim.param_groups(net.named_parameters(), WD, ("frozen",))
    state = TrainState(net, cls(groups, lr=0.0, **kw),
                       toptim.build_lr_schedule(**SCHED), clip_grad=CLIP)
    names = [n for n, _ in net.named_parameters()]
    for g in grads:
        apply_gradients(state, list(net.parameters()),
                        [torch.from_numpy(g[n].copy()) for n in names])
    err = max(np.abs(p.detach().numpy() - want[n]).max()
              for n, p in net.named_parameters())
    assert err > 1e-3


def test_unknown_opt_raises():
    with pytest.raises(ValueError):
        toptim.build_optimizer(Net(), opt="nope")


# ---------------------------------------------------------------- plateau


@pytest.mark.parametrize("kw,metrics", [
    (dict(decay_rate=0.5, patience=2, mode="max"),
     [10, 10, 10, 10, 11, 11, 10.5, 10.9, 12, 12, 12, 12, 12, 12, 12]),
    (dict(decay_rate=0.1, patience=0, mode="min", min_scale=1e-2),
     [1.0, 0.5, 0.6, 0.6, 0.4, 0.4, 0.7, 0.9]),
    (dict(decay_rate=0.3, patience=1, mode="max", cooldown=2,
          threshold=0.5),
     [1, 1.2, 1.3, 1.4, 1.4, 1.4, 1.4, 2.0, 2.1, 2.2, 2.2, 2.2, 2.2]),
], ids=["max", "min", "cooldown"])
def test_plateau_controller_matches_jax(kw, metrics):
    j, t = joptim.PlateauController(**kw), toptim.PlateauController(**kw)
    scales = []
    for m in metrics:
        scales.append(t.update(m))
        assert scales[-1] == j.update(m)
        assert (t.best, t.bad_epochs, t.cooldown_left) == (
            j.best, j.bad_epochs, j.cooldown_left)
    assert scales[-1] < 1.0  # the sequence decays at least once


@pytest.mark.parametrize("opt", ["adamw", "rmsprop"])
def test_plateau_scale_matches_jax_through_multisteps(opt):
    """The scale set to 0.5 between the two micro-steps of the third update
    (accumulation 2) multiplies the final update of the chain from that
    update on; for rmsprop after its momentum trace, not inside it."""
    init, grads = _inputs(UPDATES * 2, seed=3)
    got, state = run_port(opt, 2, init, grads, scale_at=5)
    assert toptim.plateau_scale(state.optimizer) == 0.5
    assert_close(got, run_jax(opt, 2, init, grads, scale_at=5), opt)
    # and the scale changed the result
    unscaled, _ = run_port(opt, 2, init, grads)
    assert np.abs(unscaled["fc.weight"] - got["fc.weight"]).max() > 1e-4


def test_plateau_scale_and_state_survive_a_checkpoint(tmp_path):
    """A checkpoint holds the plateau scale and the custom rule's state;
    restoring it into a fresh state and running on gives the result of
    the run that was never interrupted."""
    init, grads = _inputs(UPDATES, seed=4)
    whole, _ = run_port("rmsprop", 1, init, grads, scale_at=1, scale=0.25)
    part, state = run_port("rmsprop", 1, init, grads[:3], scale_at=1,
                           scale=0.25)
    ckpt.save_checkpoint(str(tmp_path), state)
    _, fresh = run_port("rmsprop", 1, init, [])
    ckpt.restore_checkpoint(ckpt.latest_checkpoint(str(tmp_path)), fresh)
    assert fresh.step == 3
    assert toptim.plateau_scale(fresh.optimizer) == 0.25
    buf = fresh.optimizer.state[fresh.model.fc.weight]["momentum_buffer"]
    assert buf.abs().max() > 0
    names = [n for n, _ in fresh.model.named_parameters()]
    for g in grads[3:]:
        apply_gradients(fresh, list(fresh.model.parameters()),
                        [torch.from_numpy(g[n].copy()) for n in names])
    for n, p in fresh.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), whole[n])


# ---------------------------------------------------------------- schedules


@pytest.mark.parametrize("kw", [
    dict(base_lr=0.02, steps_per_epoch=7),
    dict(base_lr=0.01, steps_per_epoch=5, milestones=(16, 22),
         warmup_iters=200, warmup_ratio=5e-3, gamma=0.5),
], ids=["1x", "2x"])
def test_mm_step_schedule_matches_jax(kw):
    j, t = joptim.mm_step_schedule(**kw), toptim.mm_step_schedule(**kw)
    steps = list(range(0, 700, 3)) + [499, 500, 501, 55, 56, 77, 80, 110]
    for s in steps:
        # atol: JAX's float32 ramp 1 - (1 - s / w)(1 - ratio) loses digits
        # to cancellation near s = 0; the port's is float64, as mmcv's
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-6,
                                   atol=2 ** -23 * kw["base_lr"], err_msg=s)
    ms = kw.get("milestones", (8, 11))
    assert t(ms[1] * kw["steps_per_epoch"]) < t(ms[0] * kw[
        "steps_per_epoch"]) < t(ms[0] * kw["steps_per_epoch"] - 1)


def test_plateau_schedule_holds_the_peak():
    kw = dict(SCHED, sched="plateau")
    j, t = joptim.build_lr_schedule(**kw), toptim.build_lr_schedule(**kw)
    for s in range(0, 30):
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-6, err_msg=s)
    assert t(2) == t(29) == toptim.scaled_lr(0.02, 512)
