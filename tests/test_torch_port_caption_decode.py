"""The port's caption decodes against the JAX package's, token for token, on
the same fp32 weights and numpy inputs: ``beam_search`` over an image grid,
``beam_search_dual`` over text + image and over grid + objects, with one
decoder and with per-language decoders, each with the port's
``decode_attention_impl`` at ``"onehot"`` and at ``"fused"`` (every step's
self-attention through ``ops/decode_attention.py``). The JAX side runs its
gather cache (the semantics the port keeps) and, once, its default windowed
cache.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.decoding.beam import beam_search as jax_beam_search
from imagetranslate_tpu.decoding.beam import (
    beam_search_dual as jax_beam_search_dual,
)
from imagetranslate_tpu.models.captioning import ImageSeq2Seq as JaxModel
from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu_torch.decoding.beam import (
    beam_search,
    beam_search_dual,
)
from imagetranslate_tpu_torch.models.captioning import ImageSeq2Seq
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.train.weights import CAPTION

IMG, V, B, T, O = 64, 40, 4, 7, 4
IMPLS = ("onehot", "fused")


class Setup:
    def __init__(self, seed, **kw):
        # A wider init than flax's 0.02, so that the decodes depend on their
        # inputs (every row of a batch decodes to other tokens).
        kw = {"vocab_size": V, "img_size": IMG, "use_obj": True,
              "initializer_range": 0.3, **kw}
        self.jcfg = jax_tiny_config(**kw)
        self.variables = CAPTION.random_params(tiny_config(**kw), seed)
        self.jm = JaxModel(self.jcfg)
        self.models = {}
        for impl in IMPLS:
            cfg = tiny_config(decode_attention_impl=impl, **kw)
            model = ImageSeq2Seq(cfg)
            model.load_state_dict(
                CAPTION.state_dict_from_flax(self.variables, cfg))
            self.models[impl] = model.eval()
        rng = np.random.RandomState(seed)
        self.images = rng.randint(0, 256, (B, IMG, IMG, 3)).astype(np.uint8)
        self.caps = rng.randint(5, V, (B, T)).astype(np.int32)
        self.mask = np.ones((B, T), bool)
        self.mask[1, 4:] = False
        self.sizes = self.mask.sum(axis=1).astype(np.int32)
        self.feats = rng.standard_normal((B, O, 1031)).astype(np.float32)
        self.labels = np.array([[1, 2, 0, 0], [3, 0, 0, 0], [2, 5, 7, 9],
                                [4, 4, 0, 0]], np.int32)
        self.first = np.full((B,), 6, np.int32)

        def apply(method, *args):
            return self.jm.apply(self.variables, *args, method=method)

        self.grid = apply(JaxModel.encode_images, jnp.asarray(self.images))
        self.gmask = np.ones(self.grid.shape[:2], bool)
        self.enc = apply(JaxModel.encode_text, self.caps, self.mask,
                         np.zeros((B,), np.int32))
        self.obj, self.okeep = apply(JaxModel.encode_objects, self.feats,
                                     self.labels)

    def port_inputs(self, model):
        """The same states from the port's own encoders."""
        with torch.no_grad():
            grid = model.encode_images(torch.tensor(self.images))
            enc = model.encode(torch.tensor(self.caps),
                               torch.tensor(self.mask),
                               torch.zeros((B,), dtype=torch.int32))
            obj, okeep = model.encode_objects(torch.tensor(self.feats),
                                              torch.tensor(self.labels))
        return grid, enc, obj, okeep


@pytest.fixture(scope="module")
def setup():
    return Setup(0)


@pytest.fixture(scope="module")
def setup_lang_dec():
    return Setup(1, lang_dec=True, num_languages=2)


def _same(got, want, what):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]),
                                  err_msg=what)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]),
                                  err_msg=what)


def _check(s, kind, lang, jax_mode="gather", sizes=False, **kw):
    kw = {"beam_width": 3, "max_len": 12, "pad_id": 0, "eos_id": 4, **kw}
    langs = np.full((B,), lang, np.int32)
    jsizes = s.sizes if sizes else None
    tsizes = torch.tensor(s.sizes) if sizes else None
    tl, first = torch.tensor(langs), torch.tensor(s.first)
    if kind == "single":
        want = jax_beam_search(s.jm, s.variables, s.grid, s.gmask, s.first,
                               langs, jsizes, mode=jax_mode, **kw)
    elif kind == "dual":
        want = jax_beam_search_dual(s.jm, s.variables, s.enc, s.mask, s.grid,
                                    s.first, langs, jsizes, mode=jax_mode,
                                    **kw)
    else:
        want = jax_beam_search_dual(
            s.jm, s.variables, s.grid, s.gmask, s.obj, s.first, langs,
            jsizes, mode=jax_mode, grid_mask=s.okeep,
            init_method=JaxModel.init_obj_dual_cache,
            step_method=JaxModel.decode_step_obj_dual, **kw)
    for impl, model in s.models.items():
        grid, enc, obj, okeep = s.port_inputs(model)
        gmask = torch.tensor(s.gmask)
        if kind == "single":
            got = beam_search(model, grid, gmask, first, tl, tsizes, **kw)
        elif kind == "dual":
            got = beam_search_dual(model, enc, torch.tensor(s.mask), grid,
                                   first, tl, tsizes, **kw)
        else:
            got = beam_search_dual(
                model, grid, gmask, obj, first, tl, tsizes, grid_mask=okeep,
                init_method=ImageSeq2Seq.init_obj_dual_cache,
                step_method=ImageSeq2Seq.decode_step_obj_dual, **kw)
        _same(got, want, f"{kind} {impl}")
    return np.asarray(want[0]), np.asarray(want[1])


@pytest.mark.parametrize("kind", ["single", "dual", "obj"])
def test_caption_decodes_match_jax_gather(setup, kind):
    best, lengths = _check(setup, kind, 0)
    assert (best[:, 0] == 6).all()
    assert len({tuple(row) for row in best}) > 1   # the inputs matter


def test_grid_decode_matches_jax_default_windowed_cache(setup):
    _check(setup, "single", 0, jax_mode=None)


def test_dual_decode_with_row_limits_and_clean_ties(setup):
    best, lengths = _check(setup, "dual", 0, sizes=True, ref_ties=False)
    assert (lengths <= np.floor(1.3 * setup.sizes + 5)).all()


def test_greedy_dual_decode(setup):
    _check(setup, "dual", 0, beam_width=1)


@pytest.mark.parametrize("kind", ["dual", "obj"])
def test_lang_dec_decodes_match_jax(setup_lang_dec, kind):
    _check(setup_lang_dec, kind, 1)


def test_fused_route_is_taken(setup, monkeypatch):
    """With ``"fused"`` a dual step calls the op once per stream and decoder
    layer, over positions 0..index; with ``"onehot"`` never."""
    from imagetranslate_tpu_torch.models import transformer

    calls = []
    op = transformer.decode_attention

    def counted(q, k, v):
        calls.append(k.shape[1])
        return op(q, k, v)

    monkeypatch.setattr(transformer, "decode_attention", counted)
    counts = {}
    for impl, model in setup.models.items():
        calls.clear()
        grid, enc, _, _ = setup.port_inputs(model)
        beam_search_dual(model, enc, torch.tensor(setup.mask), grid,
                         torch.tensor(setup.first),
                         torch.zeros((B,), dtype=torch.int32), beam_width=2,
                         max_len=5, eos_id=-1)
        counts[impl] = list(calls)
    per_step = 2 * setup.models["fused"].cfg.dec_layers
    assert counts["onehot"] == []
    assert counts["fused"] == [i + 1 for i in range(4)
                               for _ in range(per_step)]
