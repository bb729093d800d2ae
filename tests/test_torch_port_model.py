"""The port's model (imagetranslate_tpu_torch.models) against the flax
``Seq2Seq`` on the same weights.

Weights come from flax ``init`` and go through
``train/weights.state_dict_from_flax``; inputs are made from a numpy seed;
everything is fp32 at ``tiny_config`` sizes. Encoder states, teacher-forced
logits, ``decode_step`` logits and caches, and the ``project_topk`` triple
must agree within atol 2e-5 / rtol 1e-5 (fp32 sums taken in another order);
top-k indices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.models.seq2seq import Seq2Seq as JaxSeq2Seq
from imagetranslate_tpu.models.transformer import pad_bias as jax_pad_bias
from imagetranslate_tpu.train.torch_import import import_seq2seq
from imagetranslate_tpu_torch.models.config import (
    Seq2SeqConfig,
    tiny_config,
    torch_dtype,
)
from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
from imagetranslate_tpu_torch.models.transformer import pad_bias
from imagetranslate_tpu_torch.train.weights import (
    flax_from_state_dict,
    random_params,
    state_dict_from_flax,
)

ATOL, RTOL = 2e-5, 1e-5
VARIANTS = {
    "base": {},
    "tie_embed": {"tie_embed": True},
    "lang_dec": {"lang_dec": True},
    "proposals": {"use_proposals": True},
}
B, S, T, V = 3, 7, 6, 48


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(5, V, (B, S)).astype(np.int32)
    src[1, 5:] = 0                                    # padded source row
    tgt = rng.randint(5, V, (B, T)).astype(np.int32)
    tgt_mask = np.ones((B, T), bool)
    tgt_mask[2, 4:] = False
    props = rng.randint(5, V, (B, 4)).astype(np.int32)
    pmask = np.ones((B, 4), bool)
    pmask[0, 2:] = False
    pmask[2] = False                                  # a row with none
    return dict(src=src, src_mask=src != 0, tgt=tgt, tgt_mask=tgt_mask,
                src_langs=np.zeros(B, np.int32),
                tgt_langs=np.ones(B, np.int32), props=props, pmask=pmask)


class Pair:
    """A flax model and its port on the same weights."""

    def __init__(self, name):
        kw = VARIANTS[name]
        self.jcfg = jax_tiny_config(vocab_size=V, **kw)
        self.cfg = tiny_config(vocab_size=V, **kw)
        self.x = _inputs()
        x = self.x
        self.use_props = bool(kw.get("use_proposals"))
        self.pkw = (dict(proposals=x["props"], proposal_mask=x["pmask"])
                    if self.use_props else {})
        self.jm = JaxSeq2Seq(self.jcfg)
        self.params = jax.device_get(self.jm.init(
            jax.random.PRNGKey(1), x["src"], x["src_mask"], x["tgt"],
            x["tgt_mask"], x["src_langs"], x["tgt_langs"], **self.pkw))
        self.sd = state_dict_from_flax(self.params, self.cfg)
        self.model = Seq2Seq(self.cfg)
        self.model.load_state_dict(self.sd, strict=True)
        self.model.eval()

    def t(self, key):
        return torch.tensor(self.x[key])


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    return Pair(request.param)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_state_dict_round_trips_to_flax_tree(pair):
    """import_seq2seq(state_dict_from_flax(p)) == p leaf for leaf (the
    importer does not read the proposal gate; flax_from_state_dict adds
    it), and the port's own state_dict has exactly these keys."""
    want = dict(_leaves(pair.params))
    full = dict(_leaves(flax_from_state_dict(pair.sd, pair.cfg)))
    sd_np = {k: v.numpy() for k, v in pair.sd.items()}
    imported = dict(_leaves(import_seq2seq(sd_np, pair.jcfg)))
    assert set(full) == set(want)
    assert set(imported) == {k for k in want if "proposal_attn" not in k}
    for key, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(full[key]), leaf, key)
        if key in imported:
            np.testing.assert_array_equal(imported[key], leaf, key)
    assert set(pair.model.state_dict()) == set(pair.sd)


def test_random_params_have_flax_init_layout(pair):
    got = {k: np.shape(v) for k, v in _leaves(random_params(pair.cfg, 0))}
    want = {k: np.shape(v) for k, v in _leaves(pair.params)}
    assert got == want


def test_encode(pair):
    x = pair.x
    want = pair.jm.apply(pair.params, x["src"], x["src_mask"],
                         x["src_langs"], method=JaxSeq2Seq.encode)
    with torch.no_grad():
        got = pair.model.encode(pair.t("src"), pair.t("src_mask"),
                                pair.t("src_langs"))
    _close(got, want)


def test_teacher_forced_logits(pair):
    x = pair.x
    want = pair.jm.apply(pair.params, x["src"], x["src_mask"], x["tgt"],
                         x["tgt_mask"], x["src_langs"], x["tgt_langs"],
                         **pair.pkw)
    tkw = ({"proposals": pair.t("props"), "proposal_mask": pair.t("pmask")}
           if pair.use_props else {})
    with torch.no_grad():
        got = pair.model(pair.t("src"), pair.t("src_mask"), pair.t("tgt"),
                         pair.t("tgt_mask"), pair.t("src_langs"),
                         pair.t("tgt_langs"), **tkw)
    assert got.dtype == torch.float32 and got.shape == (B, T - 1, V)
    _close(got, want)


def test_decode_steps_logits_cache_and_topk(pair):
    """Three decode steps from the same cache: logits, the self-attention
    K/V buffers (bf16 by default) and the fused top-k triple."""
    x, jm, p = pair.x, pair.jm, pair.params
    L, K = 8, 3
    lang = int(x["tgt_langs"][0])
    enc = jm.apply(p, x["src"], x["src_mask"], x["src_langs"],
                   method=JaxSeq2Seq.encode)
    jcache = jm.apply(p, enc, B, L, lang, method=JaxSeq2Seq.init_cache)
    jbias = jax_pad_bias(jnp.asarray(x["src_mask"]))
    with torch.no_grad():
        tenc = torch.tensor(np.asarray(enc))
        cache = pair.model.init_cache(tenc, B, L, lang)
        tbias = pad_bias(pair.t("src_mask"))
    kw = dict(proposals=x["props"], proposal_mask=x["pmask"]) \
        if pair.use_props else {}
    tkw = {k: torch.tensor(v) for k, v in kw.items()}
    tokens = np.random.RandomState(3).randint(5, V, (3, B, 1)).astype(
        np.int32)
    for index in range(3):
        prev = tokens[index]
        (jval, jidx, jlse), _ = jm.apply(
            p, prev, jcache, index, jbias, x["tgt_langs"], lang, topk=K,
            method=JaxSeq2Seq.decode_step, **kw)
        jlogits, jcache = jm.apply(
            p, prev, jcache, index, jbias, x["tgt_langs"], lang,
            method=JaxSeq2Seq.decode_step, **kw)
        with torch.no_grad():
            snapshot = [{k: v.clone() for k, v in c.items()} for c in cache]
            val, idx, lse = pair.model.decode_step(
                torch.tensor(prev), snapshot, index, tbias,
                pair.t("tgt_langs"), lang, topk=K, **tkw)
            logits = pair.model.decode_step(
                torch.tensor(prev), cache, index, tbias, pair.t("tgt_langs"),
                lang, **tkw)
        _close(logits, jlogits)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        _close(val, jval)
        _close(lse, jlse)
        for i, c in enumerate(cache):
            jc = jcache[f"layer_{i}"]
            assert c["k"].dtype == torch_dtype(pair.cfg.kv_cache_dtype)
            for name in ("k", "v", "ek", "ev"):
                _close(c[name].float(), np.asarray(jc[name], np.float32))


def test_project_topk_matches_flax(pair):
    lang = 1 if pair.cfg.lang_dec else 0
    h = np.random.RandomState(5).randn(6, pair.cfg.hidden_size).astype(
        np.float32)
    want = pair.jm.apply(pair.params, h, 4, lang,
                         method=JaxSeq2Seq.project_topk)
    with torch.no_grad():
        val, idx, lse = pair.model.project_topk(torch.tensor(h), 4, lang)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
    _close(val, want[0])
    _close(lse, want[2])


def test_config_json_interchange():
    """Either package's config.json loads in the other, TPU-only knobs
    included; dtype names map to torch dtypes; an MoE top-k above the
    expert count is refused, as in the JAX config."""
    from imagetranslate_tpu.models.config import Seq2SeqConfig as JaxConfig

    jcfg = JaxConfig(vocab_size=100, lang_dec=True, kv_cache_dtype="float8_e4m3fn",
                     decode_attention_impl="fused", remat=True)
    cfg = Seq2SeqConfig.from_json(jcfg.to_json())
    assert cfg.to_json() == jcfg.to_json()
    assert JaxConfig.from_json(cfg.to_json()) == jcfg
    assert cfg.compute_dtype == torch.bfloat16
    assert cfg.kv_dtype == torch.float8_e4m3fn
    with pytest.raises(ValueError):
        torch_dtype("float64")
    with pytest.raises(ValueError, match="moe_top_k"):
        Seq2SeqConfig(vocab_size=8, moe_experts=4, moe_top_k=5)
