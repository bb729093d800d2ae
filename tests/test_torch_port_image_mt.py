"""The port's image streams of MT and caption training against the JAX
package's: ``ImageSeq2Seq.multimodal_mass_forward`` and
``contrastive_loss``, the three multimodal steps, ``ImageMTTrainer``, the
``mm_mode`` branch of ``CaptionTrainer`` and the image flags of
``cli.train_mt`` and ``cli.train_captioning``.

The same variables (``weights.CAPTION.random_params``, numpy) and the same
numpy batches go through both packages, fp32, ``tiny_config`` widths, ResNet
depth 1 at 64 x 64 pixels, dropout 0:

- the multimodal MASS logits within 1e-4, with ``train`` False and True (and
  the running statistics of the ``train=True`` pass within 1e-5);
- the contrastive loss and its gradient over every parameter within
  1e-6 + rtol 1e-4, with and without padding rows, all finite;
- the span masking fed JAX's draws equal to ``mass_mask`` element for element
  at span rates above 0.5 held as float32 (0.70000001 at L = 10 is where the
  float32 product and the float64 one take different ceilings);
- a 3-step SGD trajectory of each new step (multimodal MASS, text MASS,
  contrastive) under JAX's span draws, with the ResNet frozen
  (``freeze_image``; its running statistics still move): losses to rtol
  1e-5, parameters and statistics within 1e-6 + rtol 1e-4 after each step.
  The tower is frozen because its training-mode gradient under these losses
  is bound by rounding: the port's own gradient of the contrastive loss
  over the ResNet's weights moves by a few percent when the batch's rows
  are reordered; its inference-mode gradient is held above;
- the host draws (the mode, the float32 span rate, the negatives) of 20 steps
  of ``ImageMTTrainer`` and of ``CaptionTrainer`` equal to the JAX
  trainers';
- an ``ImageMTTrainer`` checkpoint with its Adam state crossing both ways and
  taking the same next step; ``graft_mt_model`` from a JAX ``Seq2Seq``
  checkpoint;
- the CLIs: ``cli.train_mt --train --image --mass_train --fstep --langs``
  through JPEGs, then ``cli.translate`` on its checkpoint; ``--pretrained``
  with ``--train`` from a multimodal and from a text checkpoint;
  ``cli.train_captioning --mmode mixed``; the refusals that stay.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagetranslate_tpu.data import images as jimages
from imagetranslate_tpu.models.captioning import ImageSeq2Seq as JaxModel
from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.ops import masking as jmasking
from imagetranslate_tpu.text.processor import TextProcessor as JaxTP
from imagetranslate_tpu.train import checkpoint as jckpt
from imagetranslate_tpu.train import optimizer as jopt
from imagetranslate_tpu.train import step as jstep
from imagetranslate_tpu.train.trainer_caption import (
    CaptionTrainer as JaxCaptionTrainer,
)
from imagetranslate_tpu.train.trainer_image_mt import (
    ImageMTTrainer as JaxImageMTTrainer,
)
from imagetranslate_tpu_torch.data import binarize_captions as pbin
from imagetranslate_tpu_torch.data import images as pimages
from imagetranslate_tpu_torch.models.captioning import ImageSeq2Seq
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.ops import masking
from imagetranslate_tpu_torch.text.processor import TextProcessor
from imagetranslate_tpu_torch.train import checkpoint as ckpt
from imagetranslate_tpu_torch.train import step as pstep
from imagetranslate_tpu_torch.train.trainer_caption import CaptionTrainer
from imagetranslate_tpu_torch.train.trainer_image_mt import ImageMTTrainer
from imagetranslate_tpu_torch.train.weights import (
    CAPTION,
    CAPTION_PARAMS,
    opt_state_from_flax,
    random_params,
    state_dict_from_flax,
)

V, IMG, B, T, N, TN = 48, 64, 8, 10, 6, 8
NSPEC, MASK_ID = 5, 3
OPT = dict(lr=1e-3, warmup_updates=4, clip_norm=1.0)
SGD_LR = 0.5
WORDS = ["alpha", "beta", "gamma", "delta", "epsi", "zeta", "theta"]
CPU = torch.device("cpu")
QUIET = dict(eval_every=10 ** 9, save_every=10 ** 9, log_every=10 ** 9)
# What the trainers read of a tokenizer in a step.
STUB_TP = types.SimpleNamespace(special_tokens=["s"] * NSPEC,
                                mask_token_id=lambda: MASK_ID,
                                pad_token_id=lambda: 0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: fastest at these sizes, and steady when other
    test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    kw = {"vocab_size": V, "img_size": IMG, **kw}
    return jax_tiny_config(**kw), tiny_config(**kw)


def _img_batch(seed, pad_row=True, mask_prob=None):
    """uint8 images, captions of several lengths with their first-pad index,
    a padding row, text negatives, and (given) a float32 span rate."""
    rng = np.random.RandomState(seed)
    caps = rng.randint(NSPEC, V, (B, T)).astype(np.int32)
    lengths = rng.randint(4, T + 1, B).astype(np.int32)
    lengths[0] = T
    caps = np.where(np.arange(T)[None, :] < lengths[:, None], caps, 0).astype(
        np.int32)
    row_mask = np.ones(B, bool)
    if pad_row:
        row_mask[-1] = False
    neg = rng.randint(NSPEC, V, (N, TN)).astype(np.int32)
    neg[:, 5:] = 0
    neg[0, 3:] = 0
    b = {"images": rng.randint(0, 256, (B, IMG, IMG, 3)).astype(np.uint8),
         "captions": caps, "caption_mask": caps != 0,
         "langs": np.zeros(B, np.int32), "row_mask": row_mask,
         "lengths": lengths, "neg": neg, "neg_mask": neg != 0,
         "neg_langs": np.zeros(N, np.int32)}
    if mask_prob is not None:
        b["mask_prob"] = np.float32(mask_prob)
    return b


def _text_batch(seed):
    rng = np.random.RandomState(seed)
    src = rng.randint(NSPEC, V, (B, 12)).astype(np.int32)
    lengths = rng.randint(4, 13, B).astype(np.int32)
    src = np.where(np.arange(12)[None, :] < lengths[:, None], src, 0).astype(
        np.int32)
    row_mask = np.ones(B, bool)
    row_mask[-1] = False
    return {"src": src, "src_mask": src != 0, "langs": np.ones(B, np.int32),
            "lengths": lengths, "row_mask": row_mask}


def _torch(batch):
    return {k: (float(v) if k == "mask_prob" else torch.as_tensor(v))
            for k, v in batch.items()}


def _port(cfg, variables):
    model = ImageSeq2Seq(cfg, param_dtype=torch.float32)
    model.load_state_dict(CAPTION.state_dict_from_flax(variables, cfg),
                          strict=True)
    return model


def jax_mass_draws(rng, src, lengths, mask_prob):
    """The draws of ``jax mass_mask(rng, ...)`` (ops/masking.py), as torch
    tensors; ``mask_prob`` as JAX holds it (a float32)."""
    r_kind, r_start, r_corrupt = jax.random.split(rng, 3)
    lengths = jnp.asarray(lengths).astype(jnp.int32)
    last_idx = jnp.maximum(jnp.ceil(lengths.astype(jnp.float32)
                                    * jnp.float32(mask_prob)).astype(
        jnp.int32), 2)
    B_ = src.shape[0]
    kind = jax.random.uniform(r_kind, (B_,))
    rand_start = jax.random.randint(r_start, (B_,), 2, last_idx + 1)
    r_choice, r_rand = jax.random.split(r_corrupt)
    u = jax.random.uniform(r_choice, src.shape)
    rand_tok = jax.random.randint(r_rand, src.shape, NSPEC, V)
    return masking.MassDraws(*(torch.tensor(np.asarray(a))
                               for a in (kind, rand_start, u, rand_tok)))


def _assert_close(sd, tree, cfg, atol=1e-6, rtol=1e-4, skip=lambda n: False):
    """Every entry of ``sd`` against the flax tree."""
    want = CAPTION.state_dict_from_flax(jax.device_get(tree), cfg)
    assert set(sd) <= set(want)
    for name, leaf in sd.items():
        if not skip(name):
            np.testing.assert_allclose(leaf.detach().numpy(),
                                       want[name].numpy(), atol=atol,
                                       rtol=rtol, err_msg=name)


class _SGD:
    """optax.sgd(lr): params -= lr * grads."""
    chain = ()

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return None

    @torch.no_grad()
    def update(self, grads, state, params):
        torch._foreach_add_(list(params.values()), grads, alpha=-self.lr)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = _cfgs()
    variables = CAPTION.random_params(cfg, 0)
    return dict(jcfg=jcfg, cfg=cfg, variables=variables,
                jvars=jax.tree.map(jnp.asarray, variables),
                jm=JaxModel(jcfg))


def _mm_inputs(b):
    """The multimodal MASS forward's inputs of batch ``b``: JAX's span
    masking at rate 0.8 with a fixed key."""
    m = jmasking.mass_mask(jax.random.PRNGKey(3), jnp.asarray(b["captions"]),
                           jnp.asarray(b["lengths"]), 0.8, mask_id=MASK_ID,
                           pad_id=0, n_specials=NSPEC, vocab_size=V,
                           span_width=T // 2 + 1)
    dec = np.asarray(m.dec_inputs)
    return (b["images"], np.asarray(m.src), b["caption_mask"], b["langs"],
            dec, dec != 0, np.asarray(m.positions))


@pytest.fixture(scope="module")
def flax_outputs(setup):
    """The flax side in one program: the multimodal MASS logits in
    inference and training mode (with the updated statistics), and the
    contrastive loss and its gradient with and without padding rows."""
    jm, b = setup["jm"], _img_batch(0)
    mm_args = _mm_inputs(b)
    con_args = tuple(b[k] for k in ("images", "captions", "caption_mask",
                                    "langs", "neg", "neg_mask", "neg_langs"))

    @jax.jit
    def run(v):
        out = {"mm_eval": jm.apply(v, *mm_args,
                                   method=JaxModel.multimodal_mass_forward),
               "mm_train": jm.apply(v, *mm_args, train=True,
                                    mutable=["batch_stats"],
                                    method=JaxModel.multimodal_mass_forward)}
        for name, rm in (("all", None), ("padded", b["row_mask"])):
            def loss(params):
                return jm.apply({"params": params,
                                 "batch_stats": v["batch_stats"]},
                                *con_args, row_mask=rm,
                                method=JaxModel.contrastive_loss)
            out[name] = jax.value_and_grad(loss)(v["params"])
        return out

    return jax.device_get(run(setup["jvars"]))


# ---------------- the two forwards ----------------

@pytest.mark.parametrize("train", [False, True])
def test_multimodal_mass_forward_matches_flax(setup, flax_outputs, train):
    cfg = setup["cfg"]
    model = _port(cfg, setup["variables"])
    args = [torch.tensor(a) for a in _mm_inputs(_img_batch(0))]
    with torch.no_grad():
        logits = model.multimodal_mass_forward(*args, train=train)
    W = T // 2 + 1
    assert logits.shape == (B, W - 1, V) and logits.dtype == torch.float32
    if not train:
        np.testing.assert_allclose(logits.numpy(), flax_outputs["mm_eval"],
                                   atol=1e-4)
        return
    want, updates = flax_outputs["mm_train"]
    np.testing.assert_allclose(logits.numpy(), want, atol=1e-4)
    _assert_close(dict(model.named_buffers()),
                  {"params": setup["variables"]["params"], **updates}, cfg,
                  atol=1e-5, rtol=0)


@pytest.mark.parametrize("rows", ["all", "padded"])
def test_contrastive_loss_and_gradient_match_jax(setup, flax_outputs, rows):
    cfg = setup["cfg"]
    model = _port(cfg, setup["variables"])
    b = _torch(_img_batch(0))
    loss = model.contrastive_loss(
        b["images"], b["captions"], b["caption_mask"], b["langs"], b["neg"],
        b["neg_mask"], b["neg_langs"],
        row_mask=b["row_mask"] if rows == "padded" else None)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    want_loss, want_grads = flax_outputs[rows]
    assert np.isfinite(float(loss.detach()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=1e-6,
                               rtol=1e-4)
    want = CAPTION_PARAMS.state_dict_from_flax(want_grads, cfg)
    for name, p, g in zip(names, params, grads):
        g = torch.zeros_like(p) if g is None else g
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-6,
                                   rtol=1e-4, err_msg=name)
    # Both pooling heads and the ResNet are trained; the decoders are not.
    for prefix, moved in (("image_attention.", True),
                          ("encoder_attention.", True),
                          ("image_model.", True), ("core.decoder.", False)):
        total = sum(float(g.abs().sum()) for n, g in zip(names, grads)
                    if n.startswith(prefix) and g is not None)
        assert (total > 0) == moved, prefix


# ---------------- the span masking above a rate of 0.5 ----------------

@pytest.mark.parametrize("mask_prob, L", [
    (0.70000001, 10), (0.730769234807874, 26), (0.55, 9), (1.0, 12)])
def test_mass_mask_above_one_half_equals_jax(mask_prob, L):
    """Span rates as the trainers draw them (a float in (0.5, 1], float32 in
    the JAX step): the end of a span clamps at the row's length, and
    last_idx is the float32 ceiling (the first two rates take another one in
    float64 at their row length L)."""
    rng = np.random.RandomState(L)
    S = 32
    lengths = np.concatenate([np.full(8, L), rng.randint(1, S + 1, 56)]
                             ).astype(np.int32)
    src = rng.randint(NSPEC, V, (64, S)).astype(np.int32)
    src = np.where(np.arange(S)[None, :] < lengths[:, None], src, 0).astype(
        np.int32)
    key = jax.random.PRNGKey(11)
    want = jmasking.mass_mask(key, jnp.asarray(src), jnp.asarray(lengths),
                              jnp.float32(mask_prob), mask_id=MASK_ID,
                              pad_id=0, n_specials=NSPEC, vocab_size=V,
                              span_width=S // 2 + 1)
    draws = jax_mass_draws(key, src, lengths, mask_prob)
    for p in (mask_prob, torch.tensor(np.float32(mask_prob))):
        got = masking.mass_mask_core(draws, torch.tensor(src),
                                     torch.tensor(lengths), p, mask_id=MASK_ID,
                                     pad_id=0, span_width=S // 2 + 1)
        for name in ("src", "dec_inputs", "positions", "span_mask"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
    last = masking._last_idx(torch.tensor(lengths[:8]), mask_prob)
    assert (last.numpy() == np.ceil(np.float32(L) * np.float32(mask_prob))
            ).all()
    if L in (10, 26):
        assert np.ceil(L * mask_prob) == last[0] + 1


# ---------------- 3-step SGD trajectories ----------------

def _jax_step(kind, jm, jcfg, optimizer):
    if kind == "mm_mass":
        return jstep.make_multimodal_mass_step(
            jm, optimizer, jcfg, n_specials=NSPEC, mask_id=MASK_ID,
            donate=False)
    if kind == "text_mass":
        return jstep.make_text_mass_step_mm(
            jm, optimizer, jcfg, mask_prob=0.5, n_specials=NSPEC,
            mask_id=MASK_ID, donate=False)
    return jstep.make_contrastive_step(jm, optimizer, donate=False)


def _port_step(kind, model, cfg, optimizer):
    if kind == "mm_mass":
        return pstep.make_multimodal_mass_step(
            model, optimizer, cfg, n_specials=NSPEC, mask_id=MASK_ID)
    if kind == "text_mass":
        return pstep.make_text_mass_step_mm(
            model, optimizer, cfg, mask_prob=0.5, n_specials=NSPEC,
            mask_id=MASK_ID)
    return pstep.make_contrastive_step(model, optimizer)


def _traj_batch(kind, i):
    if kind == "text_mass":
        return _text_batch(20 + i)
    return _img_batch(20 + i, mask_prob=(0.62, 0.81, 1.0)[i])


def _draws(kind, rng, b):
    if kind == "contrastive":
        return {}
    r_mask, _ = jax.random.split(rng)
    if kind == "text_mass":
        return {"draws": jax_mass_draws(r_mask, b["src"], b["lengths"], 0.5)}
    return {"draws": jax_mass_draws(r_mask, b["captions"], b["lengths"],
                                    b["mask_prob"])}


@pytest.mark.parametrize("kind", ["mm_mass", "text_mass", "contrastive"])
def test_three_step_sgd_trajectory_matches_jax(setup, kind):
    """The same three batches through both packages' step under plain SGD
    (``optax.sgd`` in JAX), the ResNet frozen: each step's loss, then every
    parameter and running statistic. The text MASS step leaves the
    statistics alone in both."""
    jcfg, cfg = _cfgs(freeze_image=True)
    model = _port(cfg, setup["variables"])
    optim = _SGD(SGD_LR)
    state = pstep.create_caption_train_state(model, optim)
    step = _port_step(kind, model, cfg, optim)
    jsgd = optax.sgd(SGD_LR)
    jstate = jstep.create_caption_train_state(setup["jvars"], jsgd)
    jfn = _jax_step(kind, JaxModel(jcfg), jcfg, jsgd)
    gen = torch.Generator().manual_seed(0)
    stats0 = {k: v.clone() for k, v in model.named_buffers()}
    losses = []
    for i in range(3):
        b = _traj_batch(kind, i)
        rng = jax.random.PRNGKey(40 + i)
        jstate, jm_ = jfn(jstate, b, rng)
        state, m = step(state, _torch(b), gen, **_draws(kind, rng, b))
        got = float(m["sum_loss"] / m["ntokens"])
        np.testing.assert_allclose(got, float(jm_["sum_loss"] / jm_[
            "ntokens"]), rtol=1e-5)
        assert float(m["ntokens"]) == float(jm_["ntokens"])
        losses.append(got)
        _assert_close(model.state_dict(), {"params": jstate.params,
                                           "batch_stats": jstate.batch_stats},
                      cfg)
    assert state.step == 3 and losses[0] != losses[2]
    moved = any(not torch.equal(v, stats0[k])
                for k, v in model.named_buffers())
    assert moved == (kind != "text_mass")


class _Recording:
    """An optimizer that keeps the gradients it is handed."""
    chain = ()

    def init(self, params):
        return None

    def update(self, grads, state, params):
        self.grads = [g.clone() for g in grads]


def test_caption_step_loss_weight_scales_the_gradient(setup):
    """``make_caption_train_step(loss_weight=)`` (the JAX signature's): the
    gradient scales by the weight, the metrics stay the unweighted sum."""
    cfg, b = setup["cfg"], _torch(_img_batch(3))
    out = {}
    for w in (1.0, 0.3):
        model = _port(cfg, setup["variables"])
        rec = _Recording()
        state = pstep.create_caption_train_state(model, rec)
        _, m = pstep.make_caption_train_step(model, rec, loss_weight=w)(
            state, b, torch.Generator().manual_seed(0))
        out[w] = (rec.grads, float(m["sum_loss"]))
    assert out[1.0][1] == out[0.3][1]
    for g1, g3 in zip(out[1.0][0], out[0.3][0]):
        # The scaled backward rounds in fp32 on its own way.
        np.testing.assert_allclose(g3.numpy(), 0.3 * g1.numpy(), rtol=1e-5,
                                   atol=1e-8)
    assert sum(float(g.abs().sum()) for g in out[0.3][0]) > 0


# ---------------- the host draws of both trainers ----------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A tokenizer (<en>, <fa>), JPEGs, a caption binary, monolingual MASS
    shards of both languages and a parallel file."""
    from PIL import Image

    from imagetranslate_tpu_torch.data.binarize import write_mt

    d = tmp_path_factory.mktemp("imagemt")
    rng = np.random.RandomState(0)

    def sentence(n):
        return " ".join(WORDS[j] for j in rng.randint(0, len(WORDS), n))

    (d / "c.txt").write_text("\n".join(sentence(rng.randint(2, 7))
                                       for _ in range(150)))
    TextProcessor().train_tokenizer([str(d / "c.txt")], 200, str(d / "tok"),
                                    {"<en>": 0, "<fa>": 1})
    tp = TextProcessor(str(d / "tok"))
    img = d / "images"
    img.mkdir()
    for i in range(6):
        yy, xx = np.mgrid[0:80 + 8 * i, 0:96].astype(np.float32)
        arr = np.stack([127 + 120 * np.sin(xx / (5 + c + i) + yy / 9)
                        for c in range(3)], -1).astype(np.uint8)
        Image.fromarray(arr).save(img / f"{i:02d}.jpg")
    lines = [f"{img}/{i % 6:02d}.jpg\t{sentence(rng.randint(2, 9))}"
             for i in range(44)]
    (d / "list.tsv").write_text("\n".join(lines) + "\n")
    pbin.write_from_list(tp, str(d / "caps.bin"), str(d / "list.tsv"),
                         lang="en")
    for lang in ("en", "fa"):
        (d / f"mono.{lang}").write_text("\n".join(
            sentence(rng.randint(3, 8)) for _ in range(12)))
        write_mt(tp, str(d / f"mono_{lang}"), str(d / f"mono.{lang}"),
                 tp.token_id(f"<{lang}>"))
    return d


def _recorder(log, kind):
    def step(state, batch, rng, **kw):
        neg = batch.get("neg")
        log.append((kind, None if "mask_prob" not in batch
                    else float(batch["mask_prob"]),
                    None if neg is None else np.asarray(neg).tolist()))
        return state, {"sum_loss": jnp.asarray(1.0), "ntokens":
                       jnp.asarray(1.0)}
    return step


def _stub(trainer, log, mm_mode, jax_side):
    trainer.mm_mode, trainer.mask_prob, trainer.img_size = mm_mode, 0.3, 32
    trainer.mm_mass_step = _recorder(log, "masked")
    trainer.contrastive_step = _recorder(log, "contrastive")
    trainer.state, trainer.best_bleu = None, -1.0
    trainer._save = lambda *a, **k: None
    if jax_side:
        trainer.rng, trainer.mesh = jax.random.PRNGKey(0), None
    else:
        trainer.rng, trainer.device = torch.Generator().manual_seed(0), CPU
    return trainer


@pytest.mark.parametrize("mm_mode", ["mixed", "masked"])
@pytest.mark.parametrize("trainer", ["image_mt", "caption"])
def test_host_draws_equal_the_jax_trainers(corpus, tmp_path, trainer,
                                           mm_mode):
    """Twenty image batches through each trainer's ``train_epoch``, its
    steps replaced by recorders: the same modes, float32 span rates and
    negatives, step for step (the image MT trainer keys them on its host
    step counter, the caption trainer on the step)."""
    logs = {}
    for side in ("jax", "port"):
        log = logs.setdefault(side, [])
        tp = (JaxTP if side == "jax" else TextProcessor)(str(corpus / "tok"))
        batcher = (jimages if side == "jax" else pimages).CaptionBatcher(
            str(corpus / "caps.bin"), tp, max_img_per_batch=2)
        assert len(batcher) >= 20
        cls = {("jax", "image_mt"): JaxImageMTTrainer,
               ("jax", "caption"): JaxCaptionTrainer,
               ("port", "image_mt"): ImageMTTrainer,
               ("port", "caption"): CaptionTrainer}[side, trainer]
        tr = _stub(cls.__new__(cls), log, mm_mode, side == "jax")
        tr.tp = tp
        if trainer == "image_mt":
            tr._host_step, tr._cur_img_batcher = 0, None
            tr.train_epoch(0, str(tmp_path / side), img_batcher=batcher,
                           image_root="", max_step=20, **QUIET)
        else:
            tr.train_epoch(0, str(tmp_path / side), batcher, max_step=20,
                           **QUIET)
    assert len(logs["port"]) == 20 and logs["port"] == logs["jax"]
    kinds = {k for k, _, _ in logs["port"]}
    assert kinds == ({"masked", "contrastive"} if mm_mode == "mixed"
                     else {"masked"})
    rates = [p for _, p, _ in logs["port"] if p is not None]
    assert all(0.3 <= p <= 1.0 and p == float(np.float32(p)) for p in rates)


# ---------------- checkpoints and grafting ----------------

def _trainer(cfg, variables=None):
    return ImageMTTrainer(cfg, STUB_TP, variables=variables, device="cpu",
                          lr=OPT["lr"], warmup=OPT["warmup_updates"],
                          clip=OPT["clip_norm"])


def _mt_batch(seed):
    rng = np.random.RandomState(seed)
    src = rng.randint(NSPEC, V, (B, 9)).astype(np.int32)
    dst = rng.randint(NSPEC, V, (B, T)).astype(np.int32)
    src[:, 7:] = 0
    dst[2, 5:] = 0
    return {"src": src, "src_mask": src != 0, "dst": dst,
            "dst_mask": dst != 0, "src_langs": np.zeros(B, np.int32),
            "dst_langs": np.ones(B, np.int32), "row_mask": np.ones(B, bool)}


def _no_key_bias(name):
    """Attention key biases: softmax is invariant to them, so their gradient
    is rounding noise, which Adam turns into lr-sized steps."""
    return ".self.key.bias" in name


def test_image_mt_checkpoint_crosses_both_ways(setup, tmp_path):
    """Two image steps (multimodal MASS, contrastive) under Adam, saved;
    the JAX package resumes from the checkpoint and both take the same MT
    step; then the port resumes from what JAX saved. The ResNet's Adam
    moments cross with the rest (the MT step moves the tower by them)."""
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    trainer = _trainer(cfg, setup["variables"])
    b = _torch(_img_batch(30, mask_prob=0.75))
    trainer.state, _ = trainer.mm_mass_step(trainer.state, b, trainer.rng)
    trainer.state, _ = trainer.contrastive_step(trainer.state, b, trainer.rng)
    trainer.best_bleu = 2.5
    trainer._save(str(tmp_path / "port"), 2)
    joptim = jopt.build_optimizer(**OPT)
    jvars = setup["jvars"]
    variables, opt_state, meta = jckpt.load_checkpoint(
        str(tmp_path / "port"), jax.tree.map(jnp.zeros_like, jvars),
        jax.tree.map(jnp.zeros_like, joptim.init(jvars["params"])))
    assert meta == {"step": 2, "best_metric": 2.5}
    jstate = jstep.CaptionTrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=opt_state, step=jnp.asarray(2, jnp.int32))
    jfn = jstep.make_caption_mt_train_step(setup["jm"], joptim,
                                           mtl_weight=1.0, donate=False)
    for i, tr in enumerate((trainer, None)):
        if tr is None:
            # JAX -> port: a fresh trainer resumes from what JAX saved.
            jckpt.save_checkpoint(str(tmp_path / "jax"), jcfg,
                                  {"params": jstate.params,
                                   "batch_stats": jstate.batch_stats},
                                  opt_state=jstate.opt_state, step=3)
            _, opt_tree, meta = ckpt.load_checkpoint(str(tmp_path / "jax"),
                                                     with_opt_state=True)
            tr = _trainer(cfg)
            tr.set_reference_variables(
                ckpt.load_variables(str(tmp_path / "jax")), meta["step"])
            tr.state.opt_state = opt_state_from_flax(
                opt_tree, tr.optimizer, cfg, bridge=CAPTION_PARAMS)
            assert tr.state.opt_state.count == 3
        nxt = _mt_batch(40 + i)
        jstate, jm_ = jfn(jstate, nxt, jax.random.PRNGKey(i))
        tr.state, m = tr.mt_step(tr.state, _torch(nxt), tr.rng)
        np.testing.assert_allclose(float(m["sum_loss"]),
                                   float(jm_["sum_loss"]), rtol=1e-5)
        _assert_close(tr.model.state_dict(),
                      {"params": jstate.params,
                       "batch_stats": jstate.batch_stats}, cfg, atol=2e-5,
                      rtol=0, skip=_no_key_bias)


def test_graft_mt_model_from_a_jax_seq2seq_checkpoint(setup, tmp_path):
    """A text model saved by the JAX package becomes the text core; the
    ResNet, the gate, the pooling heads and the statistics stay."""
    cfg = setup["cfg"]
    mt = random_params(cfg, 9)
    jckpt.save_checkpoint(str(tmp_path / "mt"), setup["jcfg"],
                          jax.tree.map(jnp.asarray, mt), step=5)
    trainer = _trainer(cfg, setup["variables"])
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.graft_mt_model(ckpt.load_params(str(tmp_path / "mt")))
    want = state_dict_from_flax(mt, cfg)
    got = trainer.model.state_dict()
    for name, leaf in got.items():
        if name.startswith("core."):
            np.testing.assert_array_equal(leaf.numpy(),
                                          want[name[5:]].numpy(), name)
        else:
            assert torch.equal(leaf, before[name]), name


# ---------------- CLIs ----------------

def _train_args(d, model, *extra):
    return ["--tok", str(d / "tok"), "--model", str(model),
            "--embed", "48", "--intermediate", "96", "--enc", "1",
            "--dec", "1", "--max-image", "8", "--warmup", "2",
            "--device", "cpu", *extra]


def test_cli_train_mt_with_images_then_translate(corpus, tmp_path, capsys):
    """MASS with the image stream for two steps (an image batch, then a MASS
    batch), then two fine-tune steps (an image batch, then a
    back-translation batch); ``cli.translate`` decodes with the checkpoint's
    text core."""
    from imagetranslate_tpu_torch.cli import translate
    from imagetranslate_tpu_torch.cli.train_mt import main

    model = tmp_path / "m"
    main(_train_args(corpus, model, "--train", str(corpus / "caps.bin"),
                     "--image", "", "--mass_train",
                     f"{corpus}/mono_en,{corpus}/mono_fa", "--step", "2",
                     "--fstep", "2", "--langs", "en,fa", "--mmode",
                     "masked"))
    out = capsys.readouterr().out
    assert "Image caption batches: " in out and "lang dirs" in out
    params, opt_tree, meta = ckpt.load_checkpoint(str(model) + ".latest",
                                                  with_opt_state=True)
    assert meta["step"] == 4 and opt_tree is not None
    variables = ckpt.load_variables(str(model) + ".latest")
    assert set(variables) == {"params", "batch_stats"}
    assert "image_model" in variables["params"]
    cfg = ckpt.load_config(str(model) + ".latest")
    assert (cfg.hidden_size, cfg.img_size, cfg.resnet_depth) == (48, 224, 1)
    (tmp_path / "in.txt").write_text("alpha beta gamma\ndelta zeta\n")
    translate.main(["--tok", str(corpus / "tok"), "--model",
                    str(model) + ".latest", "--input",
                    str(tmp_path / "in.txt"), "--output",
                    str(tmp_path / "out.txt"), "--src", "en", "--target",
                    "fa", "--device", "cpu"])
    assert len((tmp_path / "out.txt").read_text().splitlines()) == 2

    # --pretrained with --train: a multimodal checkpoint restores every
    # weight; a text one becomes the text core. One step at --lr 0 runs at
    # the warmup's initial rate, 1e-7, and Adam's first step is at most the
    # rate (a fresh draw differs by ~0.02).
    text = tmp_path / "text"
    text_cfg = ckpt.load_config(str(model) + ".latest")
    mt = random_params(text_cfg, 4)
    ckpt.save_params(str(text), text_cfg, mt)
    for src in (str(model) + ".latest", str(text)):
        out = tmp_path / ("again" if src == str(text) else "resumed")
        main(_train_args(corpus, out, "--train", str(corpus / "caps.bin"),
                         "--image", "", "--step", "1", "--lr", "0",
                         "--mmode", "contrastive", "--pretrained", src))
        got = ckpt.load_variables(str(out) + ".latest")["params"]
        want = (mt["params"] if src == str(text)
                else variables["params"]["core"])
        for a, w in zip(jax.tree.leaves(got["core"]), jax.tree.leaves(want)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(w),
                                       atol=2e-7, rtol=0)
        if src != str(text):
            np.testing.assert_allclose(
                np.asarray(got["multimodal_attention_gate"]),
                np.asarray(variables["params"]["multimodal_attention_gate"]),
                atol=2e-7, rtol=0)


def test_cli_train_captioning_mixed_mode(corpus, tmp_path):
    from imagetranslate_tpu_torch.cli import train_captioning

    model = str(tmp_path / "cap")
    train_captioning.main(_train_args(
        corpus, model, "--train", str(corpus / "caps.bin"), "--step", "2",
        "--mmode", "mixed", "--mask", "0.6"))
    params, opt_tree, meta = ckpt.load_checkpoint(model + ".latest",
                                                  with_opt_state=True)
    assert meta["step"] == 2 and opt_tree is not None


@pytest.mark.slow
def test_cli_train_mt_with_images_mesh_zero_under_torchrun(corpus, tmp_path):
    """``cli.train_mt --train --mesh 2x1 --zero`` (the image trainer under
    ZeRO-1) for two steps of MASS with the image stream under torchrun;
    rank 0 writes the one-device checkpoint with the gathered optimizer
    state. Slow: one torchrun launch of two ranks (~15 s)."""
    import _torch_port_ranks as ranks

    model = tmp_path / "m"
    out = ranks.torchrun(
        2, "imagetranslate_tpu_torch.cli.train_mt",
        *_train_args(corpus, model, "--train", str(corpus / "caps.bin"),
                     "--image", "", "--mass_train",
                     f"{corpus}/mono_en,{corpus}/mono_fa", "--step", "2",
                     "--mmode", "mixed", "--mesh", "2x1", "--zero"))
    assert out.count("Finished Training!") == 1
    params, opt_tree, meta = ckpt.load_checkpoint(str(model) + ".latest",
                                                  with_opt_state=True)
    assert meta["step"] == 2 and opt_tree is not None


# --mesh and --zero are ported: outside torchrun a mesh asks for it, and
# --zero without --mesh gets the JAX CLI's message. The ids keep the names
# the cases had when they were refused as unported.
@pytest.mark.parametrize("flags, message", [
    (["--lm", "x"], "--lm with --train"),
    (["--pp-microbatches", "2"], "text MT/MASS trainer only"),
    (["--mesh", "2x1"], "torchrun"),
    (["--zero"], "data axis; pass --mesh"),
], ids=["flags0---lm with --train", "flags1-text MT/MASS trainer only",
        "flags2-module 14", "flags3-module 14"])
def test_cli_train_mt_refusals_with_images(corpus, tmp_path, flags, message):
    from imagetranslate_tpu_torch.cli.train_mt import main

    with pytest.raises(SystemExit, match=message):
        main(_train_args(corpus, tmp_path / "m", "--train",
                         str(corpus / "caps.bin"), "--step", "1", *flags))
    assert not (tmp_path / "m").exists()
