"""The port's hand-written optimizer (train/optimizer.py) against the optax
chain of the JAX package on the same gradients, made from a numpy seed.

Schedule values rtol 1e-6 (both fp32). Parameters and moments after 20 updates
rtol 2e-5 / atol 1e-7: the same fp32 formulas in another operation order
(g * (limit / norm) for optax's g / norm * limit, and host-side bias
corrections). ``reset_schedule`` / ``set_schedule_step`` must move only the
schedule's count; ``wrap_accum`` must be ``optax.MultiSteps``. The state
crosses over to the optax tree and back (train/weights.py) without loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from imagetranslate_tpu.train import optimizer as jopt
from imagetranslate_tpu.train.step import wrap_accum as jax_wrap_accum
from imagetranslate_tpu_torch.train import optimizer as opt
from imagetranslate_tpu_torch.train.step import wrap_accum

RTOL, ATOL = 2e-5, 1e-7
SHAPES = {"a": (5, 7), "b": (11,), "c": (2, 3, 4)}


@pytest.mark.parametrize("lr,warmup", [(1e-4, 4000), (5e-3, 40), (1e-3, 1)])
def test_schedule_values(lr, warmup):
    want = jopt.inverse_sqrt_schedule(lr, warmup)
    got = opt.inverse_sqrt_schedule(lr, warmup)
    for count in (0, 1, 2, warmup - 1, warmup, warmup + 1, 4 * warmup,
                  10 ** 6, 10 ** 9):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                   err_msg=str(count))


def _grads(step, scale):
    rng = np.random.RandomState(100 + step)
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _params():
    rng = np.random.RandomState(0)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _run_both(n, accum=1, clip=1.0, wd=0.0, scale=1.0, between=None):
    """n updates through optax and through the port; ``between(step, jax
    state, port state)`` may edit the states after each update. Returns
    ((jax params, jax state), (port params, port state, port optimizer))."""
    kw = dict(lr=5e-3, warmup_updates=6, clip_norm=clip, weight_decay=wd)
    jo = jax_wrap_accum(jopt.build_optimizer(**kw), accum)
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    js = jo.init(jp)
    po = wrap_accum(opt.build_optimizer(**kw), accum)
    pp = {k: torch.tensor(v) for k, v in _params().items()}
    ps = po.init(pp)
    for step in range(n):
        g = _grads(step, scale)
        updates, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                                jp)
        jp = optax.apply_updates(jp, updates)
        po.update([torch.tensor(g[k]) for k in pp], ps, pp)
        if between is not None:
            js = between(step, js, ps)
    return (jp, js), (pp, ps, po)


def _assert_params(jp, pp):
    for k in SHAPES:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def _adam(js):
    return next(s for s in jax.tree.leaves(
        js, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _sched(js):
    return next(s for s in jax.tree.leaves(
        js, is_leaf=lambda s: isinstance(s, optax.ScaleByScheduleState))
        if isinstance(s, optax.ScaleByScheduleState))


@pytest.mark.parametrize("clip,wd,scale", [
    (1.0, 0.0, 1.0),      # every gradient is clipped
    (1.0, 0.0, 0.01),     # none is
    (None, 0.0, 1.0),     # no clip member in the chain
    (1.0, 0.1, 1.0),      # decayed weights
])
def test_twenty_adam_updates_match_optax(clip, wd, scale):
    (jp, js), (pp, ps, _) = _run_both(20, clip=clip, wd=wd, scale=scale)
    _assert_params(jp, pp)
    adam = _adam(js)
    assert ps.count == int(adam.count) == 20
    assert ps.schedule_count == int(_sched(js).count) == 20
    for k in SHAPES:
        np.testing.assert_allclose(ps.mu[k].numpy(), np.asarray(adam.mu[k]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ps.nu[k].numpy(), np.asarray(adam.nu[k]),
                                   rtol=RTOL, atol=1e-9)


def test_reset_and_set_schedule_step_move_only_the_schedule():
    def between(step, js, ps):
        if step == 9:
            opt.reset_schedule(ps)
            return jopt.reset_schedule(js)
        if step == 14:
            opt.set_schedule_step(ps, 1000)
            return jopt.set_schedule_step(js, 1000)
        return js

    (jp, js), (pp, ps, _) = _run_both(20, between=between)
    _assert_params(jp, pp)
    assert ps.count == int(_adam(js).count) == 20
    assert ps.schedule_count == int(_sched(js).count) == 1005
    mu = {k: v.clone() for k, v in ps.mu.items()}
    assert opt.reset_schedule(ps) is ps and ps.schedule_count == 0
    assert ps.count == 20 and all(torch.equal(mu[k], ps.mu[k]) for k in mu)


@pytest.mark.parametrize("accum,n", [(2, 20), (3, 20), (4, 7)])
def test_wrap_accum_matches_optax_multisteps(accum, n):
    (jp, js), (pp, ps, _) = _run_both(n, accum=accum)
    _assert_params(jp, pp)
    assert isinstance(js, optax.MultiStepsState)
    assert ps.mini_step == int(js.mini_step) == n % accum
    assert ps.gradient_step == int(js.gradient_step) == n // accum
    assert ps.inner_opt_state.count == n // accum
    for k in SHAPES:
        np.testing.assert_allclose(ps.acc_grads[k].numpy(),
                                   np.asarray(js.acc_grads[k]), rtol=RTOL,
                                   atol=ATOL)
    # reset reaches through the wrapper
    opt.set_schedule_step(ps, 3)
    assert ps.inner_opt_state.schedule_count == 3
    assert int(_sched(jopt.set_schedule_step(js, 3)).count) == 3


def test_accum_one_is_the_plain_optimizer():
    o = opt.build_optimizer()
    assert wrap_accum(o, 1) is o and wrap_accum(o, 0) is o
    assert isinstance(wrap_accum(o, 2), opt.MultiSteps)


def test_chain_layout_matches_the_optax_state_tuple():
    """The positions the port numbers its chain members by are those of the
    optax state tuple as flax serializes it."""
    p = {"w": jnp.ones((2, 2))}
    for clip, wd in ((1.0, 0.0), (1.0, 0.1), (None, 0.0), (0.0, 0.1)):
        kw = dict(clip_norm=clip, weight_decay=wd)
        tree = serialization.to_state_dict(
            jopt.build_optimizer(**kw).init(p))
        chain = opt.build_optimizer(**kw).chain
        assert len(chain) == len(tree)
        for i, member in enumerate(chain):
            keys = set(tree[str(i)])
            assert keys == ({"count", "mu", "nu"} if member == "adam"
                            else {"count"} if member == "schedule" else set())
