"""The port's MLM train and eval steps against the JAX package's, on the CPU,
fp32, dropout 0, from one flax initialisation, on identical batches, with the
JAX package's own ``mask_text`` draws fed to the port's steps.

- a 6-step loss trajectory (per-step loss rtol 1e-4: fp32 sums in another
  order) on the full-logits path (B * T < 8192) and on the masked-budget path
  (B = 8, T = 1024, one layer, hidden 16), and the parameters at the end
  (atol 2e-4, as in the MT and MASS trajectory tests);
- the eval step's (sum, count) under the same draws (sum rtol 1e-4, count
  equal); at T = 1024 with ``use_pallas_attention`` it goes through the
  S >= 1024 flash dispatch in both packages (Pallas interpret mode there,
  the plain version of the CUDA kernel here);
- the budget's order when the masked count overflows it: the port's stable
  sort against ``jax.lax.top_k`` (lowest indices kept), and the step's loss
  then equals the loss over exactly those positions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.models.lm import LM as JaxLM
from imagetranslate_tpu.train import optimizer as jopt
from imagetranslate_tpu.train import step as jstep
from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.lm import LM
from imagetranslate_tpu_torch.ops import flash_attention as fa
from imagetranslate_tpu_torch.ops.losses import nll_loss
from imagetranslate_tpu_torch.ops.masking import MLMDraws
from imagetranslate_tpu_torch.train import optimizer as opt
from imagetranslate_tpu_torch.train import step as pstep
from imagetranslate_tpu_torch.train import weights

V, NSPEC, MASK_ID, MASK_PROB = 48, 7, 3, 0.15
OPT = dict(lr=2e-3, warmup_updates=4, clip_norm=1.0)
CPU = torch.device("cpu")
KW = dict(mask_prob=MASK_PROB, n_specials=NSPEC, mask_id=MASK_ID)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """At these sizes one intra-op thread is the fastest, and the file's time
    stays steady when other test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lm_batch(seed, B, T):
    rng = np.random.RandomState(seed)
    # ids drawn with a skew, so that there is a unigram distribution to learn
    texts = (NSPEC + (V - NSPEC) * rng.rand(B, T) ** 3).astype(np.int32)
    lengths = rng.randint(T // 2, T + 1, B)
    texts = np.where(np.arange(T)[None, :] < lengths[:, None], texts,
                     0).astype(np.int32)
    row_mask = np.ones(B, bool)
    row_mask[-1] = False                               # a replicated tail row
    return {"texts": texts, "pad_mask": texts != 0,
            "langs": (np.arange(B) % 2).astype(np.int32),
            "row_mask": row_mask}


def _jax_mlm_draws(rng, shape) -> MLMDraws:
    """The draws ``jax mask_text(rng, ...)`` makes
    (imagetranslate_tpu/ops/masking.py), as torch tensors."""
    r_sel, r_corrupt = jax.random.split(rng)
    r_choice, r_rand = jax.random.split(r_corrupt)
    return MLMDraws(*(torch.tensor(np.asarray(a)) for a in (
        jax.random.uniform(r_sel, shape), jax.random.uniform(r_choice, shape),
        jax.random.randint(r_rand, shape, NSPEC, V))))


def _pair(B, T, **kw):
    """(JAX model, config, params, port model, port config) from one flax
    init."""
    jcfg = jax_tiny_config(vocab_size=V, num_languages=2,
                           max_position_embeddings=T, **kw)
    jmodel = JaxLM(jcfg)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(1), jnp.zeros((2, 8), jnp.int32),
        jnp.ones((2, 8), bool), jnp.zeros((2,), jnp.int32)))
    cfg = Seq2SeqConfig.from_json(jcfg.to_json())
    model = LM(cfg, param_dtype=torch.float32)
    model.load_state_dict(weights.LM.state_dict_from_flax(params, cfg))
    return jmodel, jcfg, params, model, cfg


@pytest.mark.parametrize("path,B,T,kw", [
    ("full_logits", 4, 16, {}),
    ("budget", 8, 1024, dict(hidden_size=16, num_heads=1,
                             intermediate_size=32, enc_layers=1,
                             use_pallas_attention=True)),
])
def test_mlm_loss_trajectory_eval_and_final_parameters(path, B, T, kw):
    jmodel, jcfg, params, model, cfg = _pair(B, T, **kw)
    assert (B * T >= pstep.MLM_BUDGET_MIN_TOKENS) == (path == "budget")
    joptim = jopt.build_optimizer(**OPT)
    jstate = jstep.create_train_state(params, joptim)
    jmlm = jstep.make_mlm_train_step(jmodel, joptim, jcfg, donate=False, **KW)
    jeval = jstep.make_mlm_eval_step(jmodel, jcfg, **KW)
    optim = opt.build_optimizer(**OPT)
    state = pstep.create_train_state(dict(model.named_parameters()), optim)
    mlm = pstep.make_mlm_train_step(model, optim, cfg, **KW)
    evaluate = pstep.make_mlm_eval_step(model, cfg, **KW)
    gen = torch.Generator().manual_seed(0)

    jl, pl = [], []
    for i in range(6):
        b = _lm_batch(10 + i % 3, B, T)
        rng = jax.random.PRNGKey(100 + i)
        jstate, m = jmlm(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                         rng)
        jl.append(float(m["sum_loss"]) / float(m["ntokens"]))
        r_mask, _ = jax.random.split(rng)
        state, m = mlm(state, pstep.lm_batch_to_device(b, CPU), gen,
                       draws=_jax_mlm_draws(r_mask, (B, T)))
        pl.append(m["sum_loss"].item() / m["ntokens"].item())
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert pl[-1] < pl[0] - 0.01                      # it learns
    assert state.step == int(jstate.step) == 6
    want = weights.LM.state_dict_from_flax(jax.device_get(jstate.params), cfg)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, leaf in want.items():
        if ".self.key.bias" in name:       # its gradient is rounding noise
            continue
        np.testing.assert_allclose(got[name].numpy(), leaf.numpy(),
                                   atol=2e-4, err_msg=name)

    # The eval step on the trained weights of each package, same draws.
    b = _lm_batch(20, B, T)
    erng = jax.random.PRNGKey(7)
    jsum, jn = jeval(jstate.params, {k: jnp.asarray(v) for k, v in b.items()},
                     erng)
    before = fa.LAUNCHES
    calls = []
    real = fa._FlashAttention.apply
    fa._FlashAttention.apply = lambda *a: calls.append(1) or real(*a)
    try:
        psum, pn = evaluate(pstep.lm_batch_to_device(b, CPU), None,
                            draws=_jax_mlm_draws(erng, (B, T)))
    finally:
        fa._FlashAttention.apply = real
    assert pn.item() == float(jn) > 0
    np.testing.assert_allclose(psum.item(), float(jsum), rtol=1e-4)
    # One flash call per encoder layer at T = 1024, none at T = 16; never a
    # kernel launch on the CPU.
    assert len(calls) == (cfg.enc_layers if path == "budget" else 0)
    assert fa.LAUNCHES == before
    assert not any(p.requires_grad is False for p in model.parameters())


def test_budget_order_when_the_masked_count_overflows():
    """More masked positions than the budget: ``jax.lax.top_k`` on the 0/1
    vector keeps the lowest indices among equals, and so does the port's
    stable sort; the step's loss is then the loss over exactly those."""
    B, T = 8, 1024
    _, _, _, model, cfg = _pair(B, T, hidden_size=16, num_heads=1,
                                intermediate_size=32, enc_layers=1)
    budget = pstep.mlm_budget(B * T, MASK_PROB)
    assert budget == 2560
    b = _lm_batch(3, B, T)
    batch = pstep.lm_batch_to_device(b, CPU)
    # sel = 0 selects every real position: far more than the budget.
    shape = (B, T)
    rng = np.random.RandomState(0)
    draws = MLMDraws(torch.zeros(shape),
                     torch.tensor(rng.rand(*shape).astype(np.float32)),
                     torch.tensor(rng.randint(NSPEC, V, shape)))
    flat = (b["pad_mask"] & b["row_mask"][:, None]).reshape(-1)
    assert flat.sum() > budget
    _, want_order = jax.lax.top_k(jnp.asarray(flat).astype(jnp.int32), budget)
    got_order = torch.argsort(torch.tensor(flat).to(torch.int8),
                              descending=True, stable=True)[:budget]
    np.testing.assert_array_equal(got_order.numpy(), np.asarray(want_order))
    np.testing.assert_array_equal(np.asarray(want_order),
                                  np.flatnonzero(flat)[:budget])

    optim = opt.build_optimizer(**OPT)
    state = pstep.create_train_state(dict(model.named_parameters()), optim)
    from imagetranslate_tpu_torch.ops.masking import mask_text_core

    masked = mask_text_core(draws, batch["texts"], batch["pad_mask"],
                            MASK_PROB, mask_id=MASK_ID, eos_id=cfg.eos_id)
    with torch.no_grad():
        logits = model(masked.texts, batch["pad_mask"], batch["langs"])
    kept = torch.zeros(B * T, dtype=torch.bool)
    kept[got_order] = True
    want_sum, want_n = nll_loss(logits, batch["texts"], kept.reshape(B, T))
    step = pstep.make_mlm_train_step(model, optim, cfg, **KW)
    _, m = step(state, batch, torch.Generator().manual_seed(0), draws=draws)
    assert m["ntokens"].item() == want_n.item() == budget
    np.testing.assert_allclose(m["sum_loss"].item(), want_sum.item(),
                               rtol=1e-5)


def test_mlm_step_draws_on_its_own_and_follows_the_seed():
    """Without fed draws the step draws from a device generator seeded from
    the host generator: same seed, same loss; another seed, another mask. The
    eval step's generator gives the same masks each time it is re-seeded."""
    B, T = 4, 16
    losses = []
    for seed in (0, 0, 1):
        _, _, _, model, cfg = _pair(B, T)
        optim = opt.build_optimizer(**OPT)
        state = pstep.create_train_state(dict(model.named_parameters()),
                                         optim)
        step = pstep.make_mlm_train_step(model, optim, cfg, **KW)
        _, m = step(state, pstep.lm_batch_to_device(_lm_batch(0, B, T), CPU),
                    torch.Generator().manual_seed(seed))
        assert 0 < m["ntokens"].item() < B * T
        losses.append(m["sum_loss"].item())
    assert losses[0] == losses[1] != losses[2]
    evaluate = pstep.make_mlm_eval_step(model, cfg, **KW)
    batch = pstep.lm_batch_to_device(_lm_batch(1, B, T), CPU)
    sums = [evaluate(batch, torch.Generator().manual_seed(0))[0].item()
            for _ in range(2)]
    assert sums[0] == sums[1]
