"""The MLM under a mesh (ROADMAP module 14b, parts 4-6): ``LMTrainer`` and
``LongDocTrainer`` over ``torch.distributed`` against the JAX package, fp32,
dropout 0, one spawn of four ranks over gloo on the CPU (a 2 x 1 or 1 x 2
case runs on ranks 0 and 1, as JAX's make_mesh takes the first D x M
devices). The same flax-layout parameters (the bridges' ``random_params``)
and the same global batch go through both packages; the JAX step's own
``mask_text`` draws are fed to the port's step, which takes its slice of
them.

- the BERT LM's step at 2 x 2 and 1 x 2 (heads, FFN and the word table's
  vocab rows split; ``out_bias`` whole) on the full-logits path (B * T <
  8192) and on the masked-budget path (the switch, the budget and the
  masked-first order taken over the global batch) against JAX
  ``make_mlm_train_step`` on the global batch: the loss to rtol 1e-5, the
  updated parameters and Adam's first moments to rtol 1e-4;
- the budget overflow at 2 x 1 (every real position masked): the positions
  kept are the global order's first, so the step equals one process's;
- the long-document LM's sequence parallelism at 1 x 4 (one 128-token block
  a rank, T = 512) with a ragged pad tail that crosses a shard boundary
  (tests/test_longdoc_sp.py's): the logits and one step against the
  unsharded JAX ``LongDocLM``, and at 2 x 2 against one process.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.models.lm import LM as JaxLM
from imagetranslate_tpu.models.longdoc import LongDocLM as JaxLongDoc
from imagetranslate_tpu.models.longdoc import longdoc_config
from imagetranslate_tpu.train import optimizer as jopt
from imagetranslate_tpu.train import step as jstep
from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.ops.masking import MLMDraws
from imagetranslate_tpu_torch.parallel.spawn import run_ranks
from imagetranslate_tpu_torch.train import weights
from imagetranslate_tpu_torch.train.trainer_lm import LMTrainer
from imagetranslate_tpu_torch.train.trainer_longdoc import LongDocTrainer

import _torch_port_ranks as ranks

NSPEC, MASK_ID, MASK_PROB = 5, 3, 0.15
OPT = dict(lr=1e-3, warmup=1, clip=0.05)
KW = dict(mask_prob=MASK_PROB, n_specials=NSPEC, mask_id=MASK_ID)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lm_batch(seed, B, T, V, lengths=None):
    rng = np.random.RandomState(seed)
    texts = rng.randint(NSPEC, V, (B, T)).astype(np.int32)
    if lengths is None:
        lengths = rng.randint(T // 2, T + 1, B)
    texts = np.where(np.arange(T)[None, :] < np.asarray(lengths)[:, None],
                     texts, 0).astype(np.int32)
    row_mask = np.ones(B, bool)
    row_mask[-1] = False                               # a replicated tail row
    return {"texts": texts, "pad_mask": texts != 0,
            "langs": (np.arange(B) % 2).astype(np.int32),
            "row_mask": row_mask}


def _draws(rng, shape, V):
    """The draws JAX ``mask_text(rng, ...)`` makes, as numpy arrays."""
    r_sel, r_corrupt = jax.random.split(rng)
    r_choice, r_rand = jax.random.split(r_corrupt)
    return tuple(np.asarray(a) for a in (
        jax.random.uniform(r_sel, shape), jax.random.uniform(r_choice, shape),
        jax.random.randint(r_rand, shape, NSPEC, V)))


def _jax_step(jmodel, jcfg, params, batch, rng):
    """One JAX MLM step on the global batch: (loss, params, Adam mu) as
    numpy flax trees."""
    optim = jopt.build_optimizer(lr=OPT["lr"], warmup_updates=OPT["warmup"],
                                 clip_norm=OPT["clip"])
    state = jstep.create_train_state(jax.tree.map(jnp.asarray, params),
                                     optim)
    step = jstep.make_mlm_train_step(jmodel, optim, jcfg, donate=False, **KW)
    state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                    rng)
    return (float(m["sum_loss"]) / float(m["ntokens"]),
            jax.device_get(state.params),
            jax.device_get(state.opt_state[1].mu))


LM_T = {"full": 16, "budget": 1024}
LM_B = {"full": 4, "budget": 8}


def _lm_cfg():
    jcfg = jax_tiny_config(vocab_size=48, max_position_embeddings=1024,
                           hidden_size=16, num_heads=2, intermediate_size=32,
                           enc_layers=1)
    return jcfg, Seq2SeqConfig.from_json(jcfg.to_json())


def _longdoc_cfg():
    jcfg = longdoc_config(vocab_size=211, num_languages=2, size=1).replace(
        dropout=0.0, attention_dropout=0.0, dtype="float32")
    return jcfg, Seq2SeqConfig.from_json(jcfg.to_json())


# The long-doc rows: lengths that end inside the run of every rank of a 1 x 4
# mesh, some of them across a 128-token shard boundary.
LONG_LENGTHS = [512, 312, 384, 131, 129, 500, 256, 200,
                511, 64, 383, 260, 128, 440, 300, 17]


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = _lm_cfg()
    params = weights.LM.random_params(cfg, 0)
    ljcfg, lcfg = _longdoc_cfg()
    lparams = weights.LONGDOC.random_params(lcfg, 0)
    batches, draws, jax_out = {}, {}, {}
    for path in ("full", "budget"):
        B, T = LM_B[path], LM_T[path]
        batches[path] = _lm_batch(1, B, T, cfg.vocab_size)
        rng = jax.random.PRNGKey(5)
        draws[path] = _draws(jax.random.split(rng)[0], (B, T),
                             cfg.vocab_size)
        jax_out[path] = _jax_step(JaxLM(jcfg), jcfg, params, batches[path],
                                  rng)
    # Every real position masked: far more than the budget.
    B, T = LM_B["budget"], LM_T["budget"]
    over = (np.zeros((B, T), np.float32),) + draws["budget"][1:]
    long_batch = _lm_batch(2, 16, 512, lcfg.vocab_size, LONG_LENGTHS)
    rng = jax.random.PRNGKey(9)
    long_draws = _draws(jax.random.split(rng)[0], (16, 512),
                        lcfg.vocab_size)
    jlong = JaxLongDoc(ljcfg)
    long_logits = np.asarray(jax.jit(jlong.apply)(
        jax.tree.map(jnp.asarray, lparams),
        *(jnp.asarray(long_batch[k]) for k in ("texts", "pad_mask",
                                                "langs"))))
    jax_long = _jax_step(jlong, ljcfg, lparams, long_batch, rng)
    return dict(cfg=cfg, params=params, batches=batches, draws=draws,
                jax=jax_out, over=over, lcfg=lcfg, lparams=lparams,
                long_batch=long_batch, long_draws=long_draws,
                long_logits=long_logits, jax_long=jax_long)


def _cases(s):
    lm = [("lm", s["cfg"], s["params"], s["batches"][p], mesh,
           s["draws"][p]) for p in ("full", "budget")
          for mesh in ((2, 2), (1, 2))]
    lm.append(("lm", s["cfg"], s["params"], s["batches"]["budget"], (2, 1),
               s["over"]))
    long = [("longdoc", s["lcfg"], s["lparams"], s["long_batch"], mesh,
             s["long_draws"]) for mesh in ((1, 4), (2, 2))]
    return lm + long


CASES = ["full-2x2", "full-1x2", "budget-2x2", "budget-1x2", "overflow-2x1",
         "longdoc-1x4", "longdoc-2x2"]


@pytest.fixture(scope="module")
def port(setup, tmp_path_factory):
    """Per case, the ranks' results, from one spawn of four ranks."""
    opt_kw = dict(lr=OPT["lr"], warmup=OPT["warmup"], clip=OPT["clip"], **{
        "mask_prob": MASK_PROB})
    got = run_ranks(ranks.mlm_mesh, 4,
                    str(tmp_path_factory.mktemp("mlm") / "store"),
                    (_cases(setup), opt_kw))
    return {name: [r[i] for r in got if r[i] is not None]
            for i, name in enumerate(CASES)}


def _one_process(cls, cfg, params, batch, draws):
    """The port's trainer in one process, one step: (loss, state dict,
    mu)."""
    trainer = cls(cfg, ranks.Tok(), params=params, device="cpu",
                  lr=OPT["lr"], warmup=OPT["warmup"], clip=OPT["clip"],
                  mask_prob=MASK_PROB)
    trainer.state, m = trainer.step_fn(
        trainer.state, trainer.stage(batch), torch.Generator().manual_seed(0),
        draws=MLMDraws(*(torch.tensor(a) for a in draws)))
    return (float(m["sum_loss"]) / float(m["ntokens"]),
            ranks._np(trainer.model.state_dict()),
            ranks._np(trainer.state.opt_state.mu))


def _assert_state(got, want, rtol=1e-4):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-9,
                                   err_msg=k)


def _flax(bridge, tree, cfg):
    return ranks._np(bridge.state_dict_from_flax(tree, cfg))


@pytest.mark.parametrize("case", CASES[:4])
def test_lm_step_under_a_mesh_matches_jax(setup, port, case):
    path = case.split("-")[0]
    loss, params, mu = setup["jax"][path]
    cfg = setup["cfg"]
    ranks_out = port[case]
    n_real = (setup["batches"][path]["pad_mask"]
              & setup["batches"][path]["row_mask"][:, None])
    for sum_l, n, *_ in ranks_out:
        assert 0 < n <= n_real.sum()
        np.testing.assert_allclose(sum_l / n, loss, rtol=1e-5)
    assert (LM_B[path] * LM_T[path] >= 8192) == (path == "budget")
    _assert_state(ranks_out[0][4], _flax(weights.LM, params, cfg))
    _assert_state(ranks_out[0][5], _flax(weights.LM, mu, cfg))


def test_budget_overflow_under_a_mesh_equals_one_process(setup, port):
    s = setup
    B, T = LM_B["budget"], LM_T["budget"]
    loss, sd, mu = _one_process(LMTrainer, s["cfg"], s["params"],
                                s["batches"]["budget"], s["over"])
    budget = -(-int(B * T * 2 * MASK_PROB) // 128) * 128
    for sum_l, n, *_ in port["overflow-2x1"]:
        assert n == budget          # every kept position is a masked one
        np.testing.assert_allclose(sum_l / n, loss, rtol=1e-5)
    _assert_state(port["overflow-2x1"][0][4], sd)
    _assert_state(port["overflow-2x1"][0][5], mu)


def _stitch(shares, n_data, n_model):
    """The global [B, T, V] from each rank's (d, m, [B/D, T/M, V])."""
    rows = [[None] * n_model for _ in range(n_data)]
    for d, m, x in shares:
        rows[d][m] = x
    return np.concatenate([np.concatenate(r, axis=1) for r in rows], axis=0)


@pytest.mark.parametrize("case", CASES[5:])
def test_longdoc_sequence_parallel(setup, port, case):
    s = setup
    n_data, n_model = (int(x) for x in case.split("-")[1].split("x"))
    out = port[case]
    assert len(out) == 4
    logits = _stitch([(d, m, lg) for _, _, (d, m), lg, _, _ in out],
                     n_data, n_model)
    np.testing.assert_allclose(logits, s["long_logits"], rtol=2e-5,
                               atol=2e-5)
    if n_model == 4:
        loss, params, mu = s["jax_long"]
        want_sd = _flax(weights.LONGDOC, params, s["lcfg"])
        want_mu = _flax(weights.LONGDOC, mu, s["lcfg"])
    else:
        loss, want_sd, want_mu = _one_process(
            LongDocTrainer, s["lcfg"], s["lparams"], s["long_batch"],
            s["long_draws"])
    for sum_l, n, *_ in out:
        np.testing.assert_allclose(sum_l / n, loss, rtol=1e-5)
    _assert_state(out[0][4], want_sd)
    _assert_state(out[0][5], want_mu)


def test_sequence_runs_and_host_rows():
    """The blocks must divide evenly over the model axis (the port refuses
    an uneven split); the host stages a rank's rows only."""
    from imagetranslate_tpu_torch.parallel.mesh import (
        ProcessMesh,
        host_rows,
        seq_range,
    )

    assert seq_range(ProcessMesh(2, 4, 1, 2), 512, 128) == (256, 384)
    assert seq_range(ProcessMesh(1, 2, 0, 1), 4096, 128) == (2048, 4096)
    with pytest.raises(ValueError, match="whole 128-token blocks"):
        seq_range(ProcessMesh(1, 4, 0, 0), 768, 128)
    assert host_rows(8, ProcessMesh(2, 2, 1, 0)) == slice(4, 8)
    assert host_rows(8, None) == slice(None)
    with pytest.warns(UserWarning, match="not divisible"):
        assert host_rows(6, ProcessMesh(4, 1, 1, 0)) == slice(None)
    trainer = LMTrainer(_lm_cfg()[1], ranks.Tok(), device="cpu",
                        mesh=ProcessMesh(2, 1, 1, 0))
    with pytest.raises(ValueError, match="must divide"):
        trainer.stage(_lm_batch(0, 3, 16, 48))
    got = trainer.stage(_lm_batch(0, 4, 16, 48))
    assert got["texts"].shape == (2, 16)
    assert dataclasses.is_dataclass(trainer.mesh)
