"""Layer and FFN recompute in the port (``cfg.remat``, ``cfg.remat_ffn``;
``models/remat.py``) against the JAX package's ``nn.remat``:

- at dropout 0, fp32, the port's loss and every parameter gradient under
  ``remat`` and under ``remat_ffn`` equal flax's ``Seq2Seq`` with
  ``nn.remat`` on the same weights (``random_params``) and batch, within
  1e-5 (absolute, and relative to each tensor's largest magnitude);
- at dropout 0.1 the port's three arms (off, ``remat_ffn``, ``remat``) from
  one generator seed give bit-equal losses and gradients on the CPU, the
  recompute replays the dropout seeds (each layer's attention runs again
  under ``remat`` with the seed it first drew) and leaves the stream where
  it stood;
- an MoE config reports its load-balance loss once a bank and forward under
  every arm, nothing into a sink opened during the backward, and its aux
  gradient is bit-equal across the arms;
- ``slow``: an MT step under a 1 x 2 tensor-parallel mesh on gloo ranks with
  ``remat`` equals the step without (loss, updated parameters).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.models.seq2seq import Seq2Seq as JaxSeq2Seq
from imagetranslate_tpu.ops.losses import smoothed_nll_loss as jax_loss
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.models.moe import collect_aux
from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
from imagetranslate_tpu_torch.ops import train_attention as ta
from imagetranslate_tpu_torch.ops.losses import smoothed_nll_loss
from imagetranslate_tpu_torch.train.weights import (
    random_params,
    state_dict_from_flax,
)

V, B, S, T = 48, 6, 9, 8
ARMS = ("off", "remat_ffn", "remat")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(5, V, (B, S)).astype(np.int32)
    dst = rng.randint(5, V, (B, T)).astype(np.int32)
    for i in range(B):
        src[i, rng.randint(4, S + 1):] = 0
        dst[i, rng.randint(3, T + 1):] = 0
    return (src, src != 0, dst, dst != 0, np.zeros(B, np.int32),
            np.ones(B, np.int32))


def _arm(cfg, arm):
    return dataclasses.replace(cfg, remat=arm == "remat",
                               remat_ffn=arm == "remat_ffn")


def _port_loss_and_grads(cfg, params, batch, rng=None, sinks=None):
    """(loss, {name: grad}) of the port's model on ``batch``; dropout on
    when ``rng`` (a torch.Generator) is given. ``sinks``: a list that gets
    (aux entries of the forward, aux entries during the backward)."""
    model = Seq2Seq(cfg, param_dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(params, cfg))
    src, sm, dst, dm, sl, dl = (torch.as_tensor(a) for a in batch)
    with collect_aux(model) as fwd:
        logits = model(src, sm, dst, dm, sl, dl, deterministic=rng is None,
                       rng=rng)
    s, n = smoothed_nll_loss(logits, dst[:, 1:], dm[:, 1:])
    loss = s / n
    if fwd:
        loss = loss + cfg.moe_aux_weight * sum(fwd) / len(fwd)
    names, leaves = zip(*model.named_parameters())
    with collect_aux(model) as bwd:
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    if sinks is not None:
        sinks.append((len(fwd), len(bwd)))
    return loss, {k: (torch.zeros_like(p) if g is None else g)
                  for k, p, g in zip(names, leaves, grads)}


@pytest.fixture(scope="module")
def flax_remat():
    """Loss and gradients of flax's Seq2Seq with nn.remat (fp32, dropout
    0), one compile."""
    jcfg = jax_tiny_config(vocab_size=V, dtype="float32", dropout=0.0,
                           attention_dropout=0.0, remat=True)
    cfg = tiny_config(vocab_size=V, dtype="float32", dropout=0.0,
                      attention_dropout=0.0)
    params = random_params(cfg, 3)
    batch = _batch()
    model = JaxSeq2Seq(jcfg)

    def loss_fn(p):
        src, sm, dst, dm, sl, dl = batch
        logits = model.apply(p, src, sm, dst, dm, sl, dl)
        s, n = jax_loss(logits, dst[:, 1:], dm[:, 1:])
        return s / n

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, params))
    return cfg, params, batch, float(loss), jax.device_get(grads)


@pytest.mark.parametrize("arm", ["remat", "remat_ffn"])
def test_recompute_matches_flax_remat_at_dropout_0(flax_remat, arm):
    cfg, params, batch, want_loss, want_grads = flax_remat
    loss, grads = _port_loss_and_grads(_arm(cfg, arm), params, batch)
    assert abs(loss.item() - want_loss) <= 1e-5 * max(1.0, abs(want_loss))
    want = state_dict_from_flax(want_grads, cfg)
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = torch.as_tensor(np.asarray(want[name]))
        scale = max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= 1e-5 * scale, name


def _dropout_arms(cfg, params, batch, seed=11):
    """Per arm: (loss, grads, K1 plain-version calls as (seed, shape), the
    generator's state after, aux sink sizes)."""
    out = {}
    calls = []
    ref = ta.fused_dropout_attention_reference

    def counting(q, k, v, bias, rate, seed):
        calls.append((seed, tuple(q.shape), tuple(k.shape)))
        return ref(q, k, v, bias, rate, seed)

    ta.fused_dropout_attention_reference = counting
    try:
        for arm in ARMS:
            calls.clear()
            rng = torch.Generator().manual_seed(seed)
            sinks = []
            loss, grads = _port_loss_and_grads(_arm(cfg, arm), params, batch,
                                               rng, sinks)
            out[arm] = (loss, grads, list(calls), rng.get_state(), sinks[0])
    finally:
        ta.fused_dropout_attention_reference = ref
    return out


def test_dropout_replays_bit_equal_across_arms():
    cfg = tiny_config(vocab_size=V, dtype="float32", dropout=0.1,
                      attention_dropout=0.1)
    params = random_params(cfg, 4)
    batch = _batch(1)
    out = _dropout_arms(cfg, params, batch)
    loss0, grads0, calls0, state0, _ = out["off"]
    det, _ = _port_loss_and_grads(cfg, params, batch)
    assert det.item() != loss0.item()                 # dropout is on
    attn = cfg.enc_layers + 2 * cfg.dec_layers
    assert len(calls0) == attn and len({c[0] for c in calls0}) == attn
    for arm in ("remat_ffn", "remat"):
        loss, grads, calls, state, _ = out[arm]
        assert torch.equal(loss, loss0), arm
        for name, g in grads.items():
            assert torch.equal(g, grads0[name]), (arm, name)
        assert torch.equal(state, state0), arm       # the stream moved alike
        if arm == "remat_ffn":
            assert calls == calls0
        else:
            # Every attention ran twice with the seed it first drew: once in
            # the forward, once recomputed in the backward.
            assert calls[:attn] == calls0
            assert sorted(calls[attn:]) == sorted(calls0)


def test_moe_aux_counted_once_under_recompute():
    cfg = tiny_config(vocab_size=V, dtype="float32", dropout=0.1,
                      attention_dropout=0.1, moe_experts=4, moe_top_k=2)
    params = random_params(cfg, 5)
    out = _dropout_arms(cfg, params, _batch(2))
    banks = cfg.enc_layers + cfg.dec_layers
    loss0, grads0 = out["off"][:2]
    for arm in ARMS:
        loss, grads, _, _, (fwd, bwd) = out[arm]
        assert (fwd, bwd) == (banks, 0), arm
        assert torch.equal(loss, loss0), arm
        router = [k for k in grads if k.endswith("moe.router.weight")]
        assert len(router) == banks
        for name in grads:
            assert torch.equal(grads[name], grads0[name]), (arm, name)


@pytest.mark.slow
def test_remat_under_a_tensor_parallel_mesh(tmp_path):
    """One MT step at 1 x 2 over gloo: the tensor-parallel collectives run
    again in the recompute, and the step equals the one without."""
    import _torch_port_ranks as ranks

    from imagetranslate_tpu_torch.parallel.spawn import run_ranks

    cfg = tiny_config(vocab_size=64, dtype="float32", dropout=0.1,
                      attention_dropout=0.1)
    params = random_params(cfg, 6)
    rng = np.random.RandomState(3)
    src = rng.randint(5, 64, (4, 9)).astype(np.int32)
    dst = rng.randint(5, 64, (4, 8)).astype(np.int32)
    batch = {"src": src, "src_mask": src != 0, "dst": dst,
             "dst_mask": dst != 0, "src_langs": np.zeros(4, np.int32),
             "dst_langs": np.ones(4, np.int32), "row_mask": np.ones(4, bool)}
    got = {}
    for arm in ("off", "remat"):
        got[arm] = run_ranks(
            ranks.train_step, 2, str(tmp_path / f"store_{arm}"),
            (_arm(cfg, arm), params, batch, [(1, 2)], 1e-3, 4, 1.0))
    for r in range(2):
        (l0, n0, p0, mu0), = got["off"][r]
        (l1, n1, p1, mu1), = got["remat"][r]
        assert (l1, n1) == (l0, n0)
        for k in p0:
            np.testing.assert_array_equal(p1[k], p0[k], k)
            np.testing.assert_array_equal(mu1[k], mu0[k], k)
