"""The port's beam search (imagetranslate_tpu_torch.decoding.beam) against the
JAX ``beam_search`` on the same fp32 weights: tokens and lengths equal token
for token.

Greedy and beam-4, ``ref_ties`` True and False, per-row source sizes, against
JAX ``mode="gather"`` (the semantics the port keeps) and the default windowed
mode, and with ``lang_dec`` and lexical proposals. The KV cache stays at its
default bf16 (the JAX gather path permutes it exactly; decoding/beam.py:105).
With ``decode_attention_impl="fused"`` every step's self-attention goes
through ``ops/decode_attention.py`` (on the CPU its plain version) and the
tokens stay those of the JAX decoder and of the port's ``"onehot"`` path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.decoding.beam import beam_search as jax_beam_search
from imagetranslate_tpu.decoding.beam import max_len_for as jax_max_len_for
from imagetranslate_tpu.decoding.beam import trim_outputs as jax_trim_outputs
from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.models.seq2seq import Seq2Seq as JaxSeq2Seq
from imagetranslate_tpu.decoding.beam import _gather_beams as jax_gather_beams
from imagetranslate_tpu_torch.decoding.beam import (
    beam_search,
    max_len_for,
    reorder_caches,
    trim_outputs,
)
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
from imagetranslate_tpu_torch.train.weights import state_dict_from_flax

V, B, S = 32, 4, 6


class Setup:
    def __init__(self, seed, **kw):
        # A wider init than flax's 0.02 makes the decodes depend on the
        # source: some rows stop at an EOS, others run to their limit.
        kw = {"initializer_range": 0.15, **kw}
        self.props = bool(kw.get("use_proposals"))
        self.jcfg = jax_tiny_config(vocab_size=V, **kw)
        cfg = tiny_config(vocab_size=V, **kw)
        rng = np.random.RandomState(seed)
        src = rng.randint(5, V, (B, S)).astype(np.int32)
        for row, n in enumerate((S, 4, 2, 5)):          # per-row lengths
            src[row, n:] = 0
        self.src, self.mask = src, src != 0
        self.sizes = self.mask.sum(axis=1).astype(np.int32)
        self.langs = np.zeros(B, np.int32)
        self.tgt_langs = np.ones(B, np.int32)
        self.first = np.full(B, 6, np.int32)
        self.pr = rng.randint(5, V, (B, 5)).astype(np.int32)
        self.pm = np.broadcast_to(np.arange(5)[None, :] < 3, (B, 5)).copy()
        self.pm[3] = False
        self.jm = JaxSeq2Seq(self.jcfg)
        init_kw = (dict(proposals=self.pr, proposal_mask=self.pm)
                   if self.props else {})
        self.params = jax.device_get(self.jm.init(
            jax.random.PRNGKey(seed), src, self.mask, src, self.mask,
            self.langs, self.tgt_langs, **init_kw))
        self.enc = self.jm.apply(self.params, src, self.mask, self.langs,
                                 method=JaxSeq2Seq.encode)
        self.model = Seq2Seq(cfg)
        self.model.load_state_dict(state_dict_from_flax(self.params, cfg))
        self.model.eval()
        with torch.no_grad():
            self.tenc = self.model.encode(torch.tensor(src),
                                          torch.tensor(self.mask),
                                          torch.tensor(self.langs))

    def run_jax(self, sizes=True, **kw):
        props = (self.pr, self.pm) if self.props else (None, None)
        return jax_beam_search(
            self.jm, self.params, self.enc, self.mask, self.first,
            self.tgt_langs, self.sizes if sizes else None, *props,
            pad_id=0, eos_id=4, **kw)

    def run_port(self, sizes=True, **kw):
        props = ((torch.tensor(self.pr), torch.tensor(self.pm))
                 if self.props else (None, None))
        return beam_search(
            self.model, self.tenc, torch.tensor(self.mask),
            torch.tensor(self.first), torch.tensor(self.tgt_langs),
            torch.tensor(self.sizes) if sizes else None, *props,
            pad_id=0, eos_id=4, **kw)


@pytest.fixture(scope="module")
def base():
    return Setup(0)


def _assert_same(got, want):
    best, lengths = got
    np.testing.assert_array_equal(best.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("beam_width", [1, 4])
@pytest.mark.parametrize("ref_ties", [True, False])
def test_matches_jax_gather(base, beam_width, ref_ties):
    kw = dict(beam_width=beam_width, max_len=14, ref_ties=ref_ties)
    _assert_same(base.run_port(**kw), base.run_jax(mode="gather", **kw))


def test_matches_jax_default_windowed(base):
    """The JAX default cache (windowed consolidation) decodes the same
    tokens; the port's gather semantics reproduce them."""
    kw = dict(beam_width=4, max_len=14)
    got = base.run_port(**kw)
    _assert_same(got, base.run_jax(**kw))
    # The outputs are real hypotheses: some row stops at an EOS.
    assert (got[1] < torch.tensor(np.floor(1.3 * base.sizes + 5))).any()


def test_matches_jax_without_src_sizes(base):
    kw = dict(beam_width=3, max_len=10)
    _assert_same(base.run_port(sizes=False, **kw),
                 base.run_jax(sizes=False, mode="gather", **kw))


@pytest.mark.parametrize("variant", [
    {"lang_dec": True, "num_languages": 2},
    {"use_proposals": True},
])
def test_matches_jax_lang_dec_and_proposals(variant):
    setup = Setup(1, **variant)
    for K in (1, 4):
        kw = dict(beam_width=K, max_len=14)
        _assert_same(setup.run_port(**kw),
                     setup.run_jax(mode="gather", **kw))


def test_max_len_and_trim_match_jax(base):
    for args in ((6, 1.3, 5, 64), (64, 1.3, 5, 512), (400, 1.3, 5, 512)):
        assert max_len_for(*args) == jax_max_len_for(*args)
    best, lengths = base.run_port(beam_width=4, max_len=14)
    for first in (True, False):
        assert trim_outputs(best, lengths, first) == jax_trim_outputs(
            best.numpy(), lengths.numpy(), first)


@pytest.fixture(scope="module")
def fused(base):
    """``base``'s weights in a model whose decode steps take the fused op."""
    cfg = dataclasses.replace(base.model.cfg, decode_attention_impl="fused")
    model = Seq2Seq(cfg)
    model.load_state_dict(base.model.state_dict())
    return model.eval()


@pytest.mark.parametrize("beam_width", [1, 4])
def test_fused_decode_attention_matches_jax_and_onehot(base, fused,
                                                       beam_width,
                                                       monkeypatch):
    from imagetranslate_tpu_torch.models import transformer

    calls = []
    op = transformer.decode_attention

    def counted(q, k, v):
        calls.append(k.shape[1])
        return op(q, k, v)

    kw = dict(beam_width=beam_width, max_len=14)
    onehot = base.run_port(**kw)
    monkeypatch.setattr(transformer, "decode_attention", counted)
    assert base.run_port(**kw)[0].equal(onehot[0]) and not calls
    monkeypatch.setattr(base, "model", fused)
    got = base.run_port(**kw)
    # One call per decoder layer and step, over positions 0..index only.
    layers = fused.cfg.dec_layers
    assert calls and len(calls) % layers == 0
    assert calls == [i + 1 for i in range(len(calls) // layers)
                     for _ in range(layers)]
    _assert_same(got, base.run_jax(mode="gather", **kw))
    assert got[0].equal(onehot[0]) and got[1].equal(onehot[1])


def test_fp32_cache_reorder_is_exact_where_jax_rounds():
    """The beam reorder of an fp32 KV cache. JAX's ``_gather_beams`` permutes
    through a bf16 one-hot product, so it returns the permuted cache rounded
    to bf16: off the exact rows by up to 2^-8 relative, at every step of a
    decode (a defect of the reference, left as it is). The port's index
    gather returns the rows exactly."""
    rng = np.random.RandomState(0)
    B, K, L, H, D = 2, 3, 4, 2, 8
    cache = (rng.randn(B * K, L, H, D) * 3).astype(np.float32)
    beam_idx = np.array([[2, 0, 0], [1, 2, 1]], np.int32)
    rows = (np.arange(B)[:, None] * K + beam_idx).reshape(-1)
    exact = cache[rows]
    got_jax = np.asarray(jax_gather_beams(
        {"k": jnp.asarray(cache)}, jnp.asarray(beam_idx), B, K)["k"])
    assert got_jax.dtype == np.float32
    rounded = np.asarray(jnp.asarray(exact).astype(jnp.bfloat16)
                         .astype(jnp.float32))
    np.testing.assert_array_equal(got_jax, rounded)
    rel = np.abs(got_jax - exact) / np.abs(exact)
    assert 2.0 ** -12 < rel.max() <= 2.0 ** -8
    layer = {"k": torch.tensor(cache), "v": torch.tensor(-cache)}
    caches = [[layer]]
    reorder_caches(caches, torch.tensor(rows))
    assert caches[0][0]["k"].dtype == torch.float32
    np.testing.assert_array_equal(caches[0][0]["k"].numpy(), exact)
    np.testing.assert_array_equal(caches[0][0]["v"].numpy(), -exact)
