"""The port's ``LM`` and ``LongDocLM`` against the JAX package's, on the CPU,
fp32, dropout off: logits from one flax initialisation carried over the
weight bridge (atol 2e-5: fp32 sums in another order through a few layers),
both directions of the bridge leaf for leaf, padded rows and two languages;
``local_block_attention`` alone (atol 1e-5) with a padded last block and with
a single block; the three ``longdoc_config`` presets.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.models import longdoc as jlongdoc
from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.models.lm import LM as JaxLM
from imagetranslate_tpu_torch.models import longdoc
from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.lm import LM
from imagetranslate_tpu_torch.train import weights


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """At these sizes one intra-op thread is the fastest, and the file's time
    stays steady when other test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


V, B, T = 50, 3, 16


def _batch(seed=0, T=T, n_lang=2):
    rng = np.random.RandomState(seed)
    texts = rng.randint(5, V, (B, T)).astype(np.int32)
    texts[1, T - 5:] = 0                      # a padded row
    texts[2, 1:] = 0                          # a row of one token
    langs = (np.arange(B) % n_lang).astype(np.int32)
    return texts, texts != 0, langs


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _port_cfg(jcfg) -> Seq2SeqConfig:
    return Seq2SeqConfig.from_json(jcfg.to_json())


def _init(model, T=T):
    texts, mask, langs = _batch(T=T)
    return jax.device_get(model.init(jax.random.PRNGKey(1), jnp.asarray(texts),
                                     jnp.asarray(mask), jnp.asarray(langs)))


def _assert_bridge_round_trip(bridge, params, cfg, module):
    sd = bridge.state_dict_from_flax(params, cfg)
    assert set(sd) == set(module.state_dict())
    back = dict(_leaves(bridge.flax_from_state_dict(sd, cfg)))
    want = dict(_leaves(params))
    assert set(back) == set(want)
    for key, leaf in want.items():
        np.testing.assert_array_equal(back[key], leaf, key)
    # Random params have the tree and the shapes of a flax init.
    rand = dict(_leaves(bridge.random_params(cfg, 3)))
    assert {k: v.shape for k, v in rand.items()} == {
        k: v.shape for k, v in want.items()}


def test_lm_logits_match_flax():
    jcfg = jax_tiny_config(vocab_size=V, num_languages=2)
    jmodel = JaxLM(jcfg)
    params = _init(jmodel)
    # flax inits out_bias to zeros: make the bias count.
    params["params"]["out_bias"] = np.random.RandomState(2).standard_normal(
        V).astype(np.float32)
    cfg = _port_cfg(jcfg)
    model = LM(cfg)
    _assert_bridge_round_trip(weights.LM, params, cfg, model)
    model.load_state_dict(weights.LM.state_dict_from_flax(params, cfg))
    texts, mask, langs = _batch()
    want = jmodel.apply(params, jnp.asarray(texts), jnp.asarray(mask),
                        jnp.asarray(langs))
    with torch.no_grad():
        got = model(torch.tensor(texts).long(), torch.tensor(mask),
                    torch.tensor(langs).long())
        hidden = model.encode(torch.tensor(texts).long(), torch.tensor(mask),
                              torch.tensor(langs).long())
    assert got.dtype == torch.float32 and got.shape == (B, T, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    want_h = jmodel.apply(params, jnp.asarray(texts), jnp.asarray(mask),
                          jnp.asarray(langs), method=JaxLM.encode)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_h), atol=2e-5)
    flat = hidden.reshape(B * T, -1)[:5]
    np.testing.assert_allclose(
        model.project_hidden(flat).detach().numpy(),
        np.asarray(jmodel.apply(params, jnp.asarray(flat.numpy()),
                                method=JaxLM.project_hidden)), atol=2e-5)


def test_lm_encoder_keys_are_the_translation_models():
    """The graft of ``cli.train_mt --lm`` copies the ``encoder.*`` keys."""
    from imagetranslate_tpu_torch.models.config import tiny_config
    from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq

    cfg = tiny_config(vocab_size=V)
    lm_keys = {k: v.shape for k, v in LM(cfg).state_dict().items()}
    mt_keys = {k: v.shape for k, v in Seq2Seq(cfg).state_dict().items()
               if k.startswith("encoder.")}
    assert {k: s for k, s in lm_keys.items() if k != "out_bias"} == mt_keys


@pytest.mark.parametrize("case", ["padded_last_block", "one_block",
                                  "all_padded_block"])
def test_local_block_attention_matches_jax(case):
    rng = np.random.RandomState(4)
    H, D, block = 2, 8, 8
    Tn = block if case == "one_block" else 4 * block
    q, k, v = (rng.standard_normal((B, Tn, H, D)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((B, Tn), bool)
    mask[1, Tn - 3:] = False
    if case == "all_padded_block":
        mask[2, block:2 * block] = False       # a block with no real key
        mask[2, 3 * block:] = False
    want = jlongdoc.local_block_attention(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(mask), block)
    got = longdoc.local_block_attention(
        *(torch.tensor(x) for x in (q, k, v)), torch.tensor(mask), block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_longdoc_logits_match_flax():
    block, Tn = 8, 32
    jcfg = dataclasses.replace(
        jlongdoc.longdoc_config(V, num_languages=2, size=2),
        max_position_embeddings=64, dropout=0.0, attention_dropout=0.0,
        dtype="float32")
    jmodel = jlongdoc.LongDocLM(jcfg, block=block)
    params = _init(jmodel, T=Tn)
    params["params"]["out_bias"] = np.random.RandomState(5).standard_normal(
        V).astype(np.float32)
    cfg = _port_cfg(jcfg)
    model = longdoc.LongDocLM(cfg, block=block)
    _assert_bridge_round_trip(weights.LONGDOC, params, cfg, model)
    model.load_state_dict(weights.LONGDOC.state_dict_from_flax(params, cfg))
    texts, mask, langs = _batch(T=Tn)
    want = jmodel.apply(params, jnp.asarray(texts), jnp.asarray(mask),
                        jnp.asarray(langs))
    with torch.no_grad():
        got = model(torch.tensor(texts).long(), torch.tensor(mask),
                    torch.tensor(langs).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    with pytest.raises(ValueError, match="multiples of block"):
        model.encode(torch.tensor(texts[:, :Tn - 1]).long(),
                     torch.tensor(mask[:, :Tn - 1]),
                     torch.tensor(langs).long())
    # Sequence parallelism is taken (tests/test_torch_port_mesh_lm.py); a
    # mesh without a model group splits nothing.
    from imagetranslate_tpu_torch.parallel.mesh import ProcessMesh

    one = longdoc.LongDocLM(cfg, block=block,
                            seq_sharding=ProcessMesh(2, 1))
    one.load_state_dict(model.state_dict())
    assert not one.seq_parallel
    with torch.no_grad():
        again = one(torch.tensor(texts).long(), torch.tensor(mask),
                    torch.tensor(langs).long())
    assert torch.equal(again, got)


@pytest.mark.parametrize("size", [1, 2, 3])
def test_longdoc_presets(size):
    want = jlongdoc.longdoc_config(1000, num_languages=2, size=size)
    got = longdoc.longdoc_config(1000, num_languages=2, size=size)
    assert got.to_json() == want.to_json()
    assert got.max_position_embeddings == 4096 and got.dec_layers == 0
    model = longdoc.LongDocLM(dataclasses.replace(got, vocab_size=40),
                              device="meta")
    assert len(model.layers) == got.enc_layers
    assert model.layers[0].query.weight.shape == (got.hidden_size,
                                                  got.hidden_size)
