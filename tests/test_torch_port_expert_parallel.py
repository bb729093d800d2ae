"""Expert parallelism of the port (``Seq2Seq.shard_`` of an MoE model: each
bank's experts split over the model group, models/moe.py) against the JAX
package's unsharded MoE step (JAX's own tests/test_moe.py shows its expert
parallel step equal to it), fp32 ``tiny_config`` with 4 experts, top-2, at
dropout 0. The ranks are spawned processes over gloo on the CPU
(``parallel.spawn.run_ranks``; the rank functions are in
tests/_torch_port_ranks.py): one spawn of four ranks, the 1x2 mesh on ranks
0 and 1.

- two MT steps under 1x2 and 2x2 against two JAX steps: the losses and the
  gathered parameters to rtol 1e-4; the router, its Adam moments and
  everything replicated are equal on every rank, and equal to the JAX
  step's (not n times its gradient, nor 1/n of it);
- the MoE beam decode under 1x2 gives the one-process port's tokens.
(The rule table's MoE rows are held against JAX ``shard_params`` in
tests/test_torch_port_parallel.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.models.seq2seq import Seq2Seq as JaxSeq2Seq
from imagetranslate_tpu_torch.decoding.beam import beam_search
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
from imagetranslate_tpu_torch.parallel.spawn import run_ranks
from imagetranslate_tpu_torch.train.weights import (
    random_params,
    state_dict_from_flax,
)

import _torch_port_ranks as ranks

V = 64
MOE = dict(vocab_size=V, moe_experts=4, moe_top_k=2)
CFG = tiny_config(**MOE)
OPT = dict(lr=1e-3, warmup=1, clip=0.05)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mt_batch(seed, B=8, S=7, T=6):
    rng = np.random.RandomState(seed)
    src = rng.randint(5, V, (B, S)).astype(np.int32)
    dst = rng.randint(5, V, (B, T)).astype(np.int32)
    smask = np.ones((B, S), bool)
    dmask = np.ones((B, T), bool)
    for r in range(B):
        smask[r, rng.randint(2, S):] = False
        dmask[r, rng.randint(2, T):] = False
    src[~smask] = 0
    dst[~dmask] = 0
    return {"src": src, "src_mask": smask, "dst": dst, "dst_mask": dmask,
            "src_langs": np.zeros(B, np.int32),
            "dst_langs": np.ones(B, np.int32), "row_mask": np.ones(B, bool)}


BATCHES = [("mt", _mt_batch(s)) for s in (3, 4)]
BEAM = dict(beam_width=4, max_len=12, pad_id=0, eos_id=4, ref_ties=True)


def _decode_inputs():
    rng = np.random.RandomState(0)
    B, S = 4, 6
    src = rng.randint(5, V, (B, S)).astype(np.int32)
    for row, n in enumerate((S, 4, 2, 5)):
        src[row, n:] = 0
    mask = src != 0
    return (src, mask, np.zeros(B, np.int32), np.full(B, 6, np.int32),
            np.ones(B, np.int32), mask.sum(axis=1).astype(np.int32))


@pytest.fixture(scope="module")
def jax_moe_steps():
    """Two unsharded JAX MoE steps: losses and the parameters as a port
    state_dict, plus the Adam moments of the routers."""
    from imagetranslate_tpu.train.optimizer import build_optimizer
    from imagetranslate_tpu.train.step import (
        create_train_state,
        make_mt_train_step,
    )

    params = random_params(CFG, 0)
    opt = build_optimizer(lr=OPT["lr"], warmup_updates=OPT["warmup"],
                          clip_norm=OPT["clip"])
    state = create_train_state(params, opt)
    step = make_mt_train_step(JaxSeq2Seq(jax_tiny_config(**MOE)), opt,
                              donate=False)
    losses = []
    for i, (_, b) in enumerate(BATCHES):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(i))
        losses.append(float(m["sum_loss"]) / float(m["ntokens"]))
    tree = jax.tree.map(np.asarray, state.params)
    mu = jax.tree.map(np.asarray, state.opt_state[1].mu)
    return (params, losses, state_dict_from_flax(tree, CFG),
            state_dict_from_flax(mu, CFG))


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    """One spawn of four ranks: two steps at 1x2 (ranks 0 and 1), two at
    2x2, then the beam decode at 1x2."""
    return run_ranks(ranks.expert_parallel, 4,
                     str(tmp_path_factory.mktemp("ep") / "store"),
                     (CFG, random_params(CFG, 0), BATCHES, [(1, 2), (2, 2)],
                      OPT, _decode_inputs() + (BEAM,)))


@pytest.mark.parametrize("mesh", [0, 1], ids=["1x2", "2x2"])
def test_ep_steps_match_jax_unsharded_moe(jax_moe_steps, ep_runs, mesh):
    params, losses, want, want_mu = jax_moe_steps
    results = [per_rank[0][mesh] for per_rank in ep_runs]
    if mesh == 0:
        assert results[2] is None and results[3] is None
        results = results[:2]
    plan = results[0][2]
    assert plan["encoder.encoder.layer.0.moe.wi"] == 0
    assert plan["encoder.encoder.layer.0.moe.router.weight"] is None
    for got_losses, routers, _, _ in results:
        np.testing.assert_allclose(got_losses, losses, rtol=1e-4)
        for k, (w, mu, nu) in routers.items():
            # Every rank's router is the one-process router, its moments
            # the one-process moments.
            np.testing.assert_allclose(w, want[k].numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
            np.testing.assert_allclose(mu, want_mu[k].numpy(), rtol=1e-4,
                                       atol=1e-9, err_msg=k)
            for r in results:
                for a, b in zip(r[1][k], (w, mu, nu)):
                    np.testing.assert_array_equal(a, b)
    full = results[0][3]
    assert full.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(full[k], want[k].numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_ep_beam_decode_matches_one_process(ep_runs):
    src, mask, langs, first, tgt, sizes = _decode_inputs()
    model = Seq2Seq(CFG)
    model.load_state_dict(state_dict_from_flax(random_params(CFG, 0), CFG))
    with torch.no_grad():
        enc = model.eval().encode(torch.tensor(src), torch.tensor(mask),
                                  torch.tensor(langs))
        want = beam_search(model, enc, torch.tensor(mask),
                           torch.tensor(first), torch.tensor(tgt),
                           torch.tensor(sizes), **BEAM)
    assert ep_runs[2][1] is None and ep_runs[3][1] is None
    for per_rank in ep_runs[:2]:
        best, lengths = per_rank[1]
        np.testing.assert_array_equal(best, want[0].numpy())
        np.testing.assert_array_equal(lengths, want[1].numpy())
