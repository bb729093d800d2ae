"""The port's captioning model (imagetranslate_tpu_torch.models.captioning,
models.resnet) against the flax ``ImageSeq2Seq`` on the same weights and the
same numpy inputs, fp32, at ``tiny_config`` widths and 64 x 64 images (a 2 x 2
grid): the ResNet grid encoder at depth 1 and 3 in inference mode and, at
depth 1, with batch statistics; uint8 input; ``encode_objects``; single decode
steps of ``decode_step``, ``decode_step_dual`` and ``decode_step_obj_dual``
with one decoder and with per-language decoders.

The variables come from ``weights.CAPTION.random_params`` (numpy), with
BatchNorm scales and biases moved off (1, 0) so that every statistic matters;
their tree is held against ``flax``'s own ``init``. Tolerance 1e-4 absolute on
values of magnitude ~1 (grid, logits): fp32 sums in another order through
about twenty convolutions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.models.captioning import ImageSeq2Seq as JaxModel
from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.models.transformer import pad_bias as jax_pad_bias
from imagetranslate_tpu_torch.data.images import IMAGENET_MEAN, IMAGENET_STD
from imagetranslate_tpu_torch.models.captioning import ImageSeq2Seq
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.models.transformer import pad_bias
from imagetranslate_tpu_torch.train.weights import CAPTION

IMG, V, B, T, O = 64, 48, 3, 7, 4
ATOL = 1e-4


def _perturb_bn(tree, rng):
    """BatchNorm scales and biases away from their initial (1, 0)."""
    for key, sub in tree.items():
        if isinstance(sub, dict):
            if set(sub) == {"scale", "bias"} and key.startswith(
                    ("bn", "downsample_bn")):
                n = sub["scale"].shape
                sub["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                sub["bias"] = (0.1 * rng.standard_normal(n)).astype(
                    np.float32)
            else:
                _perturb_bn(sub, rng)


class Setup:
    def __init__(self, seed=0, **kw):
        kw = {"vocab_size": V, "img_size": IMG, "initializer_range": 0.15,
              **kw}
        self.jcfg = jax_tiny_config(**kw)
        self.cfg = tiny_config(**kw)
        self.variables = CAPTION.random_params(self.cfg, seed)
        rng = np.random.RandomState(seed)
        _perturb_bn(self.variables["params"]["image_model"], rng)
        self.jm = JaxModel(self.jcfg)
        self.model = ImageSeq2Seq(self.cfg)
        self.model.load_state_dict(
            CAPTION.state_dict_from_flax(self.variables, self.cfg),
            strict=True)
        self.model.eval()
        self.images = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
        self.caps = rng.randint(5, V, (B, T)).astype(np.int32)
        self.mask = np.ones((B, T), bool)
        self.mask[1, 5:] = False
        self.langs = np.zeros((B,), np.int32)
        self.feats = rng.standard_normal((B, O, 1031)).astype(np.float32)
        self.labels = np.array([[1, 2, 0, 0], [3, 0, 0, 0], [2, 5, 7, 90]],
                               np.int32)

    def apply(self, method, *args, **kw):
        return self.jm.apply(self.variables, *args, method=method, **kw)


@pytest.fixture(scope="module")
def plain():
    return Setup()


@pytest.fixture(scope="module")
def obj():
    return Setup(1, use_obj=True)


@pytest.fixture(scope="module")
def obj_lang_dec():
    return Setup(2, use_obj=True, lang_dec=True, num_languages=2)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@pytest.mark.parametrize("kw", [
    {}, {"use_obj": True}, {"use_obj": True, "lang_dec": True},
    {"resnet_depth": 3, "tie_embed": True},
], ids=lambda kw: "-".join(kw) or "plain")
def test_random_variables_have_the_flax_tree(kw):
    """Names and shapes of ``CAPTION.random_params`` are those of flax's
    ``init`` over every submodule (traced, not run)."""
    cfg = tiny_config(vocab_size=V, img_size=IMG, **kw)
    jm = JaxModel(jax_tiny_config(vocab_size=V, img_size=IMG, **kw))
    want = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((2, IMG, IMG, 3), jnp.float32),
                        jnp.zeros((2, 6), jnp.int32), jnp.ones((2, 6), bool),
                        jnp.zeros((2,), jnp.int32),
                        method=JaxModel.init_everything))
    got = CAPTION.random_params(cfg, 0)
    assert _shapes(got) == _shapes(jax.tree.map(lambda x: x, dict(want)))
    # ... and they cross the bridge and come back unchanged.
    model = ImageSeq2Seq(cfg)
    model.load_state_dict(CAPTION.state_dict_from_flax(got, cfg), strict=True)
    back = CAPTION.flax_from_state_dict(model.state_dict(), cfg)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), back)))
    assert len(flat_got) == len(flat_back)
    for path, leaf in flat_got:
        np.testing.assert_array_equal(flat_back[path], leaf)


@pytest.mark.parametrize("depth", [1, 3])
def test_resnet_grid_matches_flax(plain, depth):
    setup = plain if depth == 1 else Setup(3, resnet_depth=3)
    want = np.asarray(setup.apply(JaxModel.encode_images, setup.images))
    with torch.no_grad():
        got = setup.model.encode_images(torch.tensor(setup.images)).numpy()
    assert got.shape == want.shape == (B, (IMG // 32) ** 2,
                                       setup.cfg.hidden_size)
    assert np.abs(want).max() > 0.1          # a real signal, not zeros
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)
    # The slots are in the JAX module's order: no permutation of them fits.
    assert np.abs(got - want[:, ::-1]).max() > 10 * ATOL


def test_resnet_grid_with_batch_statistics_matches_flax(plain):
    """``train=True``: the batch's own statistics normalise, and the running
    ones move as flax's do."""
    want, updates = plain.apply(JaxModel.encode_images, plain.images,
                                train=True, mutable=["batch_stats"])
    model = ImageSeq2Seq(plain.cfg)
    model.load_state_dict(plain.model.state_dict())
    with torch.no_grad():
        got = model.encode_images(torch.tensor(plain.images), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-4)
    new = CAPTION.flax_from_state_dict(model.state_dict(), plain.cfg)
    new = jax.tree.map(lambda t: t.numpy(), new["batch_stats"])
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(new),
                            jax.tree.leaves(updates["batch_stats"])):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5,
                                   err_msg=str(path))
    before = plain.model.image_model.bn1.running_mean
    assert not torch.equal(model.image_model.bn1.running_mean, before)


def test_uint8_images_match_float_path(plain):
    rng = np.random.RandomState(0)
    u8 = rng.randint(0, 256, (B, IMG, IMG, 3)).astype(np.uint8)
    f32 = (u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    with torch.no_grad():
        g_u = plain.model.encode_images(torch.tensor(u8))
        g_f = plain.model.encode_images(torch.tensor(f32))
    np.testing.assert_allclose(g_u.numpy(), g_f.numpy(), atol=ATOL,
                               rtol=1e-4)
    want = np.asarray(plain.apply(JaxModel.encode_images, jnp.asarray(u8)))
    np.testing.assert_allclose(g_u.numpy(), want, atol=ATOL, rtol=1e-4)


def test_encode_objects_matches_flax(obj):
    want, want_keep = obj.apply(JaxModel.encode_objects, obj.feats,
                                obj.labels)
    with torch.no_grad():
        got, keep = obj.model.encode_objects(torch.tensor(obj.feats),
                                             torch.tensor(obj.labels))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-4)
    assert (got[~keep] == 0).all() and got[keep].abs().max() > 0.1


def _streams(setup, kind):
    """(states a, mask a, states b, mask b) of a decode kind, as numpy, from
    the JAX encoders."""
    grid = np.asarray(setup.apply(JaxModel.encode_images, setup.images))
    gmask = np.ones(grid.shape[:2], bool)
    if kind == "single":
        return grid, gmask, None, None
    if kind == "dual":
        enc = np.asarray(setup.apply(JaxModel.encode_text, setup.caps,
                                     setup.mask, setup.langs))
        return enc, setup.mask, grid, gmask
    states, keep = setup.apply(JaxModel.encode_objects, setup.feats,
                               setup.labels)
    return grid, gmask, np.asarray(states), np.asarray(keep)


KINDS = {
    "single": ("init_cache", "decode_step"),
    "dual": ("init_dual_cache", "decode_step_dual"),
    "obj": ("init_obj_dual_cache", "decode_step_obj_dual"),
}


def _steps_match(setup, kind, lang):
    init, step = KINDS[kind]
    a, am, b, bm = _streams(setup, kind)
    L = 6
    langs = np.full((B,), lang, np.int32)
    states = (a,) if b is None else (a, b)
    masks = (am,) if b is None else (am, bm)
    jcache = setup.apply(getattr(JaxModel, init), *map(jnp.asarray, states),
                         B, L, lang)
    jbias = [jax_pad_bias(jnp.asarray(m)) for m in masks]
    with torch.no_grad():
        cache = getattr(setup.model, init)(*map(torch.tensor, states), B, L,
                                           lang)
        bias = [pad_bias(torch.tensor(m)) for m in masks]
        rng = np.random.RandomState(lang)
        for index in range(3):
            prev = rng.randint(5, V, (B, 1)).astype(np.int32)
            want, jcache = setup.apply(getattr(JaxModel, step),
                                       jnp.asarray(prev), jcache, index,
                                       *jbias, jnp.asarray(langs))
            got = getattr(setup.model, step)(torch.tensor(prev), cache,
                                             index, *bias,
                                             torch.tensor(langs))
            assert got.shape == (B, V) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, rtol=1e-4,
                                       err_msg=f"{kind} step {index}")
    return np.asarray(want)


@pytest.mark.parametrize("kind", ["single", "dual", "obj"])
def test_decode_steps_match_flax(obj, kind):
    _steps_match(obj, kind, 0)


@pytest.mark.parametrize("kind", ["single", "dual", "obj"])
def test_decode_steps_match_flax_lang_dec(obj_lang_dec, kind):
    first = _steps_match(obj_lang_dec, kind, 0)
    second = _steps_match(obj_lang_dec, kind, 1)
    assert np.abs(first - second).max() > 1e-2    # another decoder answers


def test_fused_decode_attention_steps_equal_onehot(obj):
    """``decode_attention_impl="fused"`` changes the self-attention's route,
    not the logits (fp32 on the CPU: the op's plain version)."""
    cfg = dataclasses.replace(obj.cfg, decode_attention_impl="fused")
    fused = ImageSeq2Seq(cfg)
    fused.load_state_dict(obj.model.state_dict())
    fused.eval()
    a, am, b, bm = _streams(obj, "obj")
    langs = torch.zeros((B,), dtype=torch.int32)
    with torch.no_grad():
        caches = [m.init_obj_dual_cache(torch.tensor(a), torch.tensor(b), B,
                                        6, 0) for m in (obj.model, fused)]
        bias = [pad_bias(torch.tensor(m)) for m in (am, bm)]
        for index in range(3):
            prev = torch.full((B, 1), 7 + index)
            outs = [m.decode_step_obj_dual(prev, c, index, *bias, langs)
                    for m, c in zip((obj.model, fused), caches)]
            np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(),
                                       atol=1e-5, rtol=0)
