"""The port's caption training path against the JAX package's: the training
forwards of ``ImageSeq2Seq``, the three caption steps, the caption batcher and
binarizers, ``CaptionTrainer`` and ``cli.train_captioning``.

The same variables (``weights.CAPTION.random_params``, numpy) and the same
numpy batches go through both packages, fp32, ``tiny_config`` widths, ResNet
depth 1 at 64 x 64 pixels (a 2 x 2 grid), dropout 0:

- ``caption_forward`` / ``caption_forward_with_objects`` logits within 1e-4
  (fp32 sums through twenty convolutions in another order) and the
  ``train=True`` running statistics within 1e-5;
- a 3-step trajectory of ``make_caption_train_step`` under plain SGD
  (``optax.sgd`` in JAX, the same update in the port): per-step losses to
  rtol 1e-4, parameters and running statistics within 1e-5 after each step
  (the first step's parameter change is the gradient);
- the object step's loss and statistics against the flax forward's; the MT
  stream's gradient, ``mtl_weight`` included, against the JAX step's under
  plain SGD (its parameter change is the gradient), to 1e-6 + rtol 1e-4;
- ``freeze_image``: the ResNet's parameters bit-equal after a step, its
  statistics those of the flax step;
- batches, evaluation groups and detections equal; binaries byte for byte;
- a trainer checkpoint with its Adam state resumes in the other package and
  takes the same next step: loss rtol 1e-5, statistics within 1e-4,
  parameters within 2e-5 except two kinds of leaves, whose Adam steps after
  the first are rounding-sensitive and which the SGD trajectory holds: the
  attention key biases (softmax is invariant to them, so their gradient is
  rounding noise) and the ResNet's parameters (a training-mode BatchNorm
  follows every convolution, so the loss does not see a channel's scale:
  the tower's gradients are small differences of large sums, spread over
  five decades, and Adam turns the rounding of the small ones into steps of
  up to lr);
- K1's plain version called at the caption, object and MT-stream shapes
  (the 49-slot grid among them) and K5's never, on the CPU;
- ``cli.binarize_captions_from_list`` -> ``cli.train_captioning`` (2 steps,
  the MT stream, an MT checkpoint grafted by ``--lm``, a dev BLEU) ->
  ``cli.caption``; caption BLEU equal to the
  JAX trainer's on the same hypotheses; packed caption binaries read as the
  marshal ones; the refusals.
"""

import collections
import dataclasses
import json
import marshal
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagetranslate_tpu.data import binarize_captions as jbin
from imagetranslate_tpu.data import images as jimages
from imagetranslate_tpu.models.captioning import ImageSeq2Seq as JaxModel
from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.ops.losses import smoothed_nll_loss as jax_loss
from imagetranslate_tpu.text.processor import TextProcessor as JaxTP
from imagetranslate_tpu.train import checkpoint as jckpt
from imagetranslate_tpu.train import optimizer as jopt
from imagetranslate_tpu.train import step as jstep
from imagetranslate_tpu_torch.data import binarize_captions as pbin
from imagetranslate_tpu_torch.data import images as pimages
from imagetranslate_tpu_torch.models.captioning import ImageSeq2Seq
from imagetranslate_tpu_torch.models.config import Seq2SeqConfig, tiny_config
from imagetranslate_tpu_torch.ops import train_attention as ta
from imagetranslate_tpu_torch.ops import xent
from imagetranslate_tpu_torch.text.processor import TextProcessor
from imagetranslate_tpu_torch.train import checkpoint as ckpt
from imagetranslate_tpu_torch.train import optimizer as opt
from imagetranslate_tpu_torch.train import step as pstep
from imagetranslate_tpu_torch.train.trainer_caption import CaptionTrainer
from imagetranslate_tpu_torch.train.weights import (
    CAPTION,
    CAPTION_PARAMS,
    opt_state_from_flax,
    random_params,
)

V, IMG, B, T, O = 48, 64, 8, 8, 4
OPT = dict(lr=1e-3, warmup_updates=4, clip_norm=1.0)
WORDS = ["alpha", "beta", "gamma", "delta", "epsi", "zeta", "theta"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: fastest at these sizes, and steady when other
    test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    kw = {"vocab_size": V, "img_size": IMG, "use_obj": True, **kw}
    return jax_tiny_config(**kw), tiny_config(**kw)


def _batch(seed, img=IMG, rows=B):
    """uint8 images, captions with padding, a padding row, detections with
    a row of padding only."""
    rng = np.random.RandomState(seed)
    caps = rng.randint(5, V, (rows, T)).astype(np.int32)
    for i in range(rows):
        caps[i, rng.randint(3, T + 1):] = 0
    row_mask = np.ones(rows, bool)
    row_mask[-1] = False
    labels = rng.randint(1, 91, (rows, O)).astype(np.int32)
    labels[:, 2:] = 0
    labels[1] = 0                                   # no detection at all
    return {"images": rng.randint(0, 256, (rows, img, img, 3)).astype(
                np.uint8),
            "captions": caps, "caption_mask": caps != 0,
            "langs": np.zeros(rows, np.int32), "row_mask": row_mask,
            "box_features": rng.standard_normal((rows, O, 1031)).astype(
                np.float32),
            "object_labels": labels}


def _mt_batch(seed):
    rng = np.random.RandomState(seed)
    src = rng.randint(5, V, (B, 9)).astype(np.int32)
    dst = rng.randint(5, V, (B, T)).astype(np.int32)
    src[:, 7:] = 0
    dst[2, 5:] = 0
    return {"src": src, "src_mask": src != 0, "dst": dst, "dst_mask": dst != 0,
            "src_langs": np.zeros(B, np.int32),
            "dst_langs": np.ones(B, np.int32), "row_mask": np.ones(B, bool)}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _port(cfg, variables):
    model = ImageSeq2Seq(cfg, param_dtype=torch.float32)
    model.load_state_dict(CAPTION.state_dict_from_flax(variables, cfg),
                          strict=True)
    return model


def _noise_free(name):
    """Leaves whose Adam steps after the first are not rounding-sensitive
    (see the module docstring; running statistics are not parameters)."""
    resnet = name.startswith("image_model.") and "running_" not in name
    return ".self.key.bias" not in name and not resnet


def _assert_close(sd, tree, cfg, atol, skip_key_bias=False,
                  stats_atol=1e-5):
    """Every entry of ``sd`` against the flax tree; running statistics
    within ``stats_atol``."""
    want = CAPTION.state_dict_from_flax(jax.device_get(tree), cfg)
    assert set(sd) <= set(want)
    for name, leaf in sd.items():
        if skip_key_bias and not _noise_free(name):
            continue
        tol = stats_atol if "running_" in name else atol
        np.testing.assert_allclose(leaf.detach().numpy(), want[name].numpy(),
                                   atol=tol, err_msg=name)


SGD_LR = 0.5


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


class _Recording:
    """An optimizer that keeps the gradients it is handed."""
    chain = ()

    def init(self, params):
        return None

    def update(self, grads, state, params):
        self.grads = [g.clone() for g in grads]


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = _cfgs()
    variables = CAPTION.random_params(cfg, 0)
    jvars = jax.tree.map(jnp.asarray, variables)
    jm = JaxModel(jcfg)
    joptim = jopt.build_optimizer(lr=OPT["lr"], warmup_updates=OPT[
        "warmup_updates"], clip_norm=OPT["clip_norm"])
    jstep_fn = jstep.make_caption_train_step(jm, joptim, donate=False)
    return dict(jcfg=jcfg, cfg=cfg, variables=variables, jvars=jvars, jm=jm,
                joptim=joptim, jstep=jstep_fn)


@pytest.fixture(scope="module")
def flax_forwards(setup):
    """The flax forwards on batch 0 in training mode: (logits, updated
    batch_stats) of both caption forwards."""
    jm, b = setup["jm"], _batch(0)

    @jax.jit
    def run(v):
        out = {}
        for name, args in (
                ("grid", (b["images"], b["captions"], b["caption_mask"],
                          b["langs"])),
                ("obj", (b["images"], b["box_features"], b["object_labels"],
                         b["captions"], b["caption_mask"], b["langs"]))):
            method = (JaxModel.caption_forward if name == "grid"
                      else JaxModel.caption_forward_with_objects)
            out[name] = jm.apply(v, *args, train=True,
                                 mutable=["batch_stats"], method=method)
        return out

    return jax.device_get(run(setup["jvars"]))


@pytest.fixture(scope="module")
def trajectory(setup):
    """Three SGD caption steps in both packages from the same
    variables."""
    cfg = setup["cfg"]
    model = _port(cfg, setup["variables"])
    optim = _SGD(SGD_LR)
    state = pstep.create_caption_train_state(model, optim)
    step = pstep.make_caption_train_step(model, optim)
    jsgd = optax.sgd(SGD_LR)
    jstate = jstep.create_caption_train_state(setup["jvars"], jsgd)
    jfn = jstep.make_caption_train_step(setup["jm"], jsgd, donate=False)
    gen = torch.Generator().manual_seed(0)
    out = {"port_loss": [], "jax_loss": [], "port_sd": [], "jax_vars": []}
    for i in range(3):
        b = _batch(10 + i)
        state, m = step(state, _torch(b), gen)
        jstate, jm_ = jfn(jstate, b, jax.random.PRNGKey(i))
        out["port_loss"].append(float(m["sum_loss"] / m["ntokens"]))
        out["jax_loss"].append(float(jm_["sum_loss"] / jm_["ntokens"]))
        out["port_sd"].append({k: v.clone() for k, v in
                               model.state_dict().items()})
        out["jax_vars"].append(jax.device_get(
            {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    assert state.step == 3
    return out


# ---------------- forwards ----------------

@pytest.mark.parametrize("kind", ["grid", "obj"])
def test_caption_forwards_and_batch_statistics_match_flax(setup,
                                                          flax_forwards,
                                                          kind):
    cfg, b = setup["cfg"], _torch(_batch(0))
    model = _port(cfg, setup["variables"])
    before = {k: v.clone() for k, v in model.named_buffers()}
    with torch.no_grad():
        if kind == "grid":
            logits = model.caption_forward(
                b["images"], b["captions"], b["caption_mask"], b["langs"],
                train=True)
        else:
            logits = model.caption_forward_with_objects(
                b["images"], b["box_features"], b["object_labels"],
                b["captions"], b["caption_mask"], b["langs"], train=True)
    want, updates = flax_forwards[kind]
    assert logits.shape == (B, T - 1, V) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want, atol=1e-4)
    _assert_close(dict(model.named_buffers()),
                  {"params": setup["variables"]["params"], **updates}, cfg,
                  atol=1e-5)
    assert all(not torch.equal(before[k], v)
               for k, v in model.named_buffers())
    # Inference mode reads the statistics and leaves them alone.
    moved = {k: v.clone() for k, v in model.named_buffers()}
    with torch.no_grad():
        model.caption_forward(b["images"], b["captions"],
                              b["caption_mask"], b["langs"])
    assert all(torch.equal(v, moved[k]) for k, v in model.named_buffers())


# ---------------- the three steps ----------------

def test_caption_step_trajectory_matches_flax(setup, trajectory):
    np.testing.assert_allclose(trajectory["port_loss"],
                               trajectory["jax_loss"], rtol=1e-4)
    assert trajectory["port_loss"][0] != trajectory["port_loss"][2]
    for sd, jvars in zip(trajectory["port_sd"], trajectory["jax_vars"]):
        _assert_close(sd, jvars, setup["cfg"], atol=1e-5)


def test_object_step_loss_and_statistics_match_flax(setup, flax_forwards):
    cfg = setup["cfg"]
    model = _port(cfg, setup["variables"])
    optim = opt.build_optimizer(**OPT)
    state = pstep.create_caption_train_state(model, optim)
    step = pstep.make_caption_obj_train_step(model, optim)
    before = {k: v.clone() for k, v in model.named_parameters()}
    b = _batch(0)
    state, m = step(state, _torch(b), torch.Generator().manual_seed(0))
    logits, updates = flax_forwards["obj"]
    mask = b["caption_mask"][:, 1:] & b["row_mask"][:, None]
    sum_l, n = jax_loss(jnp.asarray(logits), b["captions"][:, 1:], mask,
                        epsilon=0.1)
    np.testing.assert_allclose(float(m["sum_loss"]), float(sum_l), rtol=1e-5)
    assert float(m["ntokens"]) == float(n)
    _assert_close(dict(model.named_buffers()),
                  {"params": setup["variables"]["params"], **updates}, cfg,
                  atol=1e-5)
    # Both decoders, both embedding tables and the gate were trained.
    for prefix in ("obj_decoder.", "obj_embeddings.", "core.decoder.",
                   "multistream_attention_gate", "image_model.",
                   "object_feat_fc."):
        assert any(not torch.equal(p, before[k]) for k, p in
                   model.named_parameters() if k.startswith(prefix)), prefix


def _assert_gradients(model, grads, before, after, cfg):
    """The port's gradients against a JAX SGD(1) step's parameter change."""
    delta = jax.tree.map(lambda a, c: np.asarray(a) - np.asarray(c),
                         before, jax.device_get(after))
    want = CAPTION_PARAMS.state_dict_from_flax(delta, cfg)
    for (name, _), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-6,
                                   rtol=1e-4, err_msg=name)
    assert sum(float(g.abs().sum()) for g in grads) > 0


@pytest.mark.parametrize("mtl_weight", [0.1, 1.0])
def test_mt_stream_step_gradient_and_weight_match_jax(setup, mtl_weight):
    """The JAX step under SGD(1): its parameter change is minus the
    weighted gradient, which the port's step hands its optimizer."""
    cfg = setup["cfg"]
    model = _port(cfg, setup["variables"])
    rec = _Recording()
    state = pstep.create_caption_train_state(model, rec)
    stats = {k: v.clone() for k, v in model.named_buffers()}
    b = _mt_batch(3)
    state, m = pstep.make_caption_mt_train_step(
        model, rec, mtl_weight=mtl_weight)(state, _torch(b),
                                           torch.Generator().manual_seed(0))
    jstate = jstep.create_caption_train_state(setup["jvars"], optax.sgd(1.0))
    jfn = jstep.make_caption_mt_train_step(setup["jm"], optax.sgd(1.0),
                                           mtl_weight=mtl_weight,
                                           donate=False)
    jnew, jm_ = jfn(jstate, b, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(m["sum_loss"]), float(jm_["sum_loss"]),
                               rtol=1e-5)
    _assert_gradients(model, rec.grads, setup["jvars"]["params"],
                      jnew.params, cfg)
    # The ResNet and its statistics are not touched.
    assert all(torch.equal(v, stats[k]) for k, v in model.named_buffers())


def test_freeze_image_keeps_the_resnet_and_moves_its_statistics(setup,
                                                                trajectory):
    jcfg, cfg = _cfgs(freeze_image=True)
    model = _port(cfg, setup["variables"])
    optim = opt.build_optimizer(**OPT)
    state = pstep.create_caption_train_state(model, optim)
    before = {k: v.clone() for k, v in model.named_parameters()}
    pstep.make_caption_train_step(model, optim)(
        state, _torch(_batch(10)), torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        if name.startswith("image_model."):
            assert torch.equal(p, before[name]), name
    assert not torch.equal(model.core.decoder.decoder.layer[0].output[
        "dense"].weight, before["core.decoder.decoder.layer.0.output.dense."
                                "weight"])
    # The statistics move as in the flax step (which froze nothing: the
    # statistics of a step do not depend on the gradient).
    _assert_close(dict(model.named_buffers()), trajectory["jax_vars"][0],
                  cfg, atol=1e-5)


def test_k1_at_the_caption_shapes_and_no_k5(monkeypatch):
    """With dropout on, every attention of the three steps goes through the
    fused dropout attention (here its plain version), at the 49-slot grid of
    224-pixel images and over the detections; the caption steps never reach
    the fused cross-entropy, even with ``use_pallas_xent``."""
    _, cfg = _cfgs(img_size=224, dropout=0.1, attention_dropout=0.1,
                   fused_attn_dropout=True, use_pallas_xent=True)
    model = _port(cfg, CAPTION.random_params(cfg, 0))
    optim = opt.build_optimizer(**OPT)
    state = pstep.create_caption_train_state(model, optim)
    k1, k5 = [], []
    attn, rows = ta.fused_dropout_attention_reference, \
        xent.smoothed_xent_rows_reference
    monkeypatch.setattr(ta, "fused_dropout_attention_reference",
                        lambda q, k, v, bias, *a: k1.append(
                            (q.shape[1], k.shape[1], tuple(bias.shape)))
                        or attn(q, k, v, bias, *a))
    monkeypatch.setattr(xent, "smoothed_xent_rows_reference",
                        lambda *a: k5.append(1) or rows(*a))
    gen = torch.Generator().manual_seed(0)
    b = _torch(_batch(0, img=224, rows=2))
    L, t = cfg.dec_layers, T - 1
    self_ = (t, t, (2, 1, t, t))
    grid = (t, 49, (2, 1, 1, 49))
    objs = (t, O, (2, 1, 1, O))
    state, m = pstep.make_caption_train_step(model, optim)(state, b, gen)
    assert k1 == [self_, grid] * L and not k5
    k1.clear()
    state, m = pstep.make_caption_obj_train_step(model, optim)(state, b, gen)
    assert k1 == [self_, grid] * L + [self_, objs] * L and not k5
    k1.clear()
    mt = _torch(_mt_batch(0))
    mt = {k: v[:2] for k, v in mt.items()}
    state, m = pstep.make_caption_mt_train_step(model, optim)(state, mt, gen)
    assert k1 == [(9, 9, (2, 1, 1, 9))] * cfg.enc_layers + [
        self_, (t, 9, (2, 1, 1, 9))] * L and not k5
    assert np.isfinite(float(m["sum_loss"])) and state.step == 3
    # The counter does see the fused loss where a step uses it.
    pstep.make_mt_train_step(model, optim)(state, mt, gen)
    assert k5


# ---------------- checkpoints ----------------

def _jax_templates(setup):
    jvars = setup["jvars"]
    return (jax.tree.map(jnp.zeros_like, jvars),
            jax.tree.map(jnp.zeros_like, setup["joptim"].init(
                jvars["params"])))


def test_trainer_checkpoint_crosses_both_ways(setup, tmp_path):
    cfg, jstep_fn = setup["cfg"], setup["jstep"]
    trainer = CaptionTrainer(cfg, None, variables=setup["variables"],
                             device="cpu", **{k: OPT[k] for k in ("lr",)},
                             warmup=OPT["warmup_updates"],
                             clip=OPT["clip_norm"])
    for i in range(2):
        trainer.state, _ = trainer.cap_step(trainer.state,
                                            _torch(_batch(20 + i)),
                                            trainer.rng)
    trainer.best_bleu = 3.5
    trainer._save(str(tmp_path / "port"), 2)
    # port -> JAX: the restored state takes the same next step.
    variables, opt_state, meta = jckpt.load_checkpoint(
        str(tmp_path / "port"), *_jax_templates(setup))
    assert meta == {"step": 2, "best_metric": 3.5}
    jstate = jstep.CaptionTrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=opt_state, step=jnp.asarray(2, jnp.int32))
    nxt = _batch(30)
    jstate, jm_ = jstep_fn(jstate, nxt, jax.random.PRNGKey(5))
    trainer.state, m = trainer.cap_step(trainer.state, _torch(nxt),
                                        trainer.rng)
    np.testing.assert_allclose(float(m["sum_loss"]), float(jm_["sum_loss"]),
                               rtol=1e-5)
    jvars = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    _assert_close(trainer.model.state_dict(), jvars, cfg, atol=2e-5,
                  skip_key_bias=True, stats_atol=1e-4)
    # JAX -> port: a fresh trainer resumes from what JAX saved.
    jckpt.save_checkpoint(str(tmp_path / "jax"), setup["jcfg"], jvars,
                          opt_state=jstate.opt_state, step=3)
    params, opt_tree, meta = ckpt.load_checkpoint(str(tmp_path / "jax"),
                                                  with_opt_state=True)
    assert meta["step"] == 3
    resumed = CaptionTrainer(cfg, None, device="cpu", lr=OPT["lr"],
                             warmup=OPT["warmup_updates"],
                             clip=OPT["clip_norm"])
    resumed.set_reference_variables(ckpt.load_variables(str(tmp_path / "jax")),
                                    step=meta["step"])
    resumed.state.opt_state = opt_state_from_flax(
        opt_tree, resumed.optimizer, cfg, bridge=CAPTION_PARAMS)
    assert resumed.state.opt_state.count == 3
    nxt = _batch(31)
    resumed.state, m = resumed.cap_step(resumed.state, _torch(nxt),
                                        resumed.rng)
    jstate, jm_ = jstep_fn(jstate, nxt, jax.random.PRNGKey(6))
    np.testing.assert_allclose(float(m["sum_loss"]), float(jm_["sum_loss"]),
                               rtol=1e-5)
    _assert_close(resumed.model.state_dict(),
                  {"params": jstate.params, "batch_stats": jstate.batch_stats},
                  cfg, atol=2e-5, skip_key_bias=True, stats_atol=1e-4)


# ---------------- host side: binaries, batches ----------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A tokenizer, JPEGs, a caption list, a COCO JSON and wiki documents."""
    from PIL import Image

    d = tmp_path_factory.mktemp("captrain")
    rng = np.random.RandomState(0)

    def sentence(n):
        return " ".join(WORDS[j] for j in rng.randint(0, len(WORDS), n))

    (d / "c.txt").write_text("\n".join(sentence(rng.randint(2, 7))
                                       for _ in range(150)))
    TextProcessor().train_tokenizer([str(d / "c.txt")], 200, str(d / "tok"),
                                    {"<en>": 0, "<fa>": 1})
    img = d / "images"
    img.mkdir()
    for i in range(10):
        yy, xx = np.mgrid[0:80 + 8 * i, 0:96].astype(np.float32)
        arr = np.stack([127 + 120 * np.sin(xx / (5 + c + i) + yy / 9)
                        for c in range(3)], -1).astype(np.uint8)
        Image.fromarray(arr).save(img / f"{i:02d}.jpg")
    (img / "broken.jpg").write_bytes(b"not a jpeg")
    Image.fromarray(arr).save(img / "p.png")
    lines = [f"{img}/{i % 10:02d}.jpg\t{sentence(rng.randint(2, 9))}"
             for i in range(37)]
    lines += [f"{img}/{3:02d}\t{sentence(4)}",           # extension sniffed
              f"{img}/p.png\t{sentence(3)}",             # skipped by batchers
              "a line without a tab",
              f"{img}/04.jpg\t<en> {sentence(3)} </s>",  # tagged already
              f"{img}/05.jpg\t{sentence(60)}"]           # too long
    (d / "list.tsv").write_text("\n".join(lines) + "\n")
    (d / "coco.json").write_text(json.dumps({"annotations": [
        {"image_id": int(i % 7) * 1000 + 3, "caption": sentence(5)}
        for i in range(20)]}))
    docs = []
    for k in range(4):
        sens = [sentence(rng.randint(3, 9)) for _ in range(5)]
        docs.append({"content": "<en> " + " </s> ".join(sens),
                     "images": [{"img_path": f"{(k + j) % 12:02d}.jpg"
                                 if (k + j) % 12 < 10 else "broken.jpg",
                                 "caption": "<en> " + sens[j][:20] + " </s>"}
                                for j in range(2)]})
    (d / "wiki.json").write_text(json.dumps(docs))
    (d / "ref.json").write_text(json.dumps(docs[1:3]))
    return d


def _tps(d):
    return JaxTP(str(d / "tok")), TextProcessor(str(d / "tok"))


@pytest.mark.parametrize("kind, kw", [
    ("list", {"lang": "en"}), ("list", {"sample_size": 20}),
    ("list", {"max_len": 8}), ("coco", {}), ("coco", {"sample_size": 7}),
    ("wiki", {}), ("wiki", {"only_captions": True}),
    ("wiki", {"choose_relevant": False}), ("wiki", {"ref": True}),
    ("wiki", {"check": True}),
])
def test_binarizers_write_the_jax_bytes(corpus, tmp_path, kind, kw):
    jtp, tp = _tps(corpus)
    out = {}
    for name, mod, t in (("jax", jbin, jtp), ("port", pbin, tp)):
        path = str(tmp_path / name)
        kw2 = dict(kw)
        if kind == "list":
            n = mod.write_from_list(t, path, str(corpus / "list.tsv"), **kw2)
        elif kind == "coco":
            n = mod.write_from_coco(t, path, str(corpus / "coco.json"), **kw2)
        else:
            ref = kw2.pop("ref", False)
            check = kw2.pop("check", False)
            n = mod.write_from_wiki_json(
                t, path, str(corpus / "wiki.json"),
                ref_file=str(corpus / "ref.json") if ref else None,
                root_img_dir=str(corpus / "images"), skip_check=not check,
                **kw2)
        out[name] = (n, open(path, "rb").read())
    assert out["port"] == out["jax"] and out["port"][0] > 0
    if kind == "wiki" and kw.get("check"):
        images, _ = marshal.loads(out["port"][1])
        assert "broken.jpg" not in images.values()


@pytest.fixture(scope="module")
def binary(corpus):
    _, tp = _tps(corpus)
    path = str(corpus / "caps.bin")
    pbin.write_from_list(tp, path, str(corpus / "list.tsv"), lang="en")
    return path


@pytest.mark.parametrize("kw", [{}, {"max_capacity_mb": 0.02,
                                     "max_img_per_batch": 5}])
def test_caption_batcher_equals_jax(corpus, binary, kw):
    jtp, tp = _tps(corpus)
    jb = jimages.CaptionBatcher(binary, jtp, **kw)
    pb = pimages.CaptionBatcher(binary, tp, **kw)
    assert len(pb) == len(jb) > 0 and pb.lang == jb.lang
    assert pb.all_captions == jb.all_captions

    def same(a, b):
        assert a.image_paths == b.image_paths
        for f in ("captions", "caption_mask", "langs", "lengths", "row_mask"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert getattr(a, f).dtype == getattr(b, f).dtype
        assert a.captions.shape[0] % 8 == 0

    for a, b in zip(pb, jb):
        same(a, b)
    for seed in (0, 3):
        for a, b in zip(pb.shuffled(seed), jb.shuffled(seed)):
            same(a, b)
    np.testing.assert_array_equal(pb.sample_negatives(8, 5),
                                  jb.sample_negatives(8, 5))
    # The images of a batch, uint8 at the requested size.
    imgs = pb.batches[0].images(size=64, raw=True)
    assert imgs.shape == (pb.batches[0].captions.shape[0], 64, 64, 3)
    assert imgs.dtype == np.uint8


def test_eval_set_and_object_store_equal_jax(corpus, binary, tmp_path):
    jtp, tp = _tps(corpus)
    je, pe = jimages.CaptionEvalSet(binary, jtp), pimages.CaptionEvalSet(
        binary, tp)
    assert pe.max_len == je.max_len and pe.lang == je.lang
    assert [dataclasses.astuple(g) for g in pe.groups] == [
        dataclasses.astuple(g) for g in je.groups]
    assert [len(g) for g in pe.batches(4)] == [len(g) for g in je.batches(4)]
    rng = np.random.RandomState(0)
    arrays = {}
    for g in pe.groups[:3]:
        arrays[f"{g.image_path}||feat"] = rng.standard_normal(
            (5, 1031)).astype(np.float32)
        arrays[f"{g.image_path}||lab"] = rng.randint(0, 91, 5).astype(
            np.int32)
    np.savez(tmp_path / "objs.npz", **arrays)
    paths = [g.image_path for g in pe.groups[1:6]]
    want = jimages.ObjectStore(str(tmp_path / "objs.npz")).lookup(paths, 8)
    got = pimages.ObjectStore(str(tmp_path / "objs.npz")).lookup(paths, 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert got[1][2:].sum() == 0 and got[1][:2].any()


def test_caption_bleu_equals_the_jax_trainers(corpus, binary, tmp_path):
    """Both trainers' ``eval_caption_bleu`` over the same evaluation set,
    their decodes replaced by the same hypotheses: the same references,
    score and transcripts."""
    from imagetranslate_tpu.train.trainer_caption import (
        CaptionTrainer as JaxTrainer,
    )

    jtp, tp = _tps(corpus)

    def hypotheses():
        calls = iter(range(100))

        def caption_images(images, first, langs, L, **kw):
            r = np.random.RandomState(next(calls))
            best = r.randint(5, tp.vocab_size(), (len(images), L))
            best[:, 0] = first
            return best, r.randint(2, 7, len(images))
        return caption_images

    jt = JaxTrainer.__new__(JaxTrainer)
    jt.tp, jt.img_size, jt.best_bleu = jtp, 64, -1.0
    jt.caption_reference = collections.defaultdict(list)
    jt.caption_images = hypotheses()
    jt._save = lambda *a: None
    jt.state = jstep.CaptionTrainState(None, None, None, jnp.asarray(0))
    _, cfg = _cfgs(vocab_size=tp.vocab_size(), use_obj=False)
    pt = CaptionTrainer(cfg, tp, device="cpu")
    pt.caption_images = hypotheses()
    saved = []
    pt._save = lambda path, step: saved.append(step)
    scores = {}
    for name, tr in (("jax", jt), ("port", pt)):
        out = tmp_path / name
        scores[name] = tr.eval_caption_bleu(
            jimages.CaptionEvalSet(binary, jtp) if name == "jax"
            else pimages.CaptionEvalSet(binary, tp), "", str(out))
    assert scores["port"] == scores["jax"] and pt.best_bleu == jt.best_bleu
    assert dict(pt.caption_reference) == dict(jt.caption_reference)
    for f in ("bleu.caption.output", "bleu.caption.best.output"):
        assert (tmp_path / "port" / f).read_text() == (
            tmp_path / "jax" / f).read_text()
    assert saved == [0]


# ---------------- CLIs and refusals ----------------

def test_cli_train_captioning_then_caption(corpus, tmp_path):
    from imagetranslate_tpu_torch.cli import binarize_captions_from_list
    from imagetranslate_tpu_torch.cli import caption as caption_cli
    from imagetranslate_tpu_torch.cli import train_captioning
    from imagetranslate_tpu_torch.data.binarize import write_mt

    _, tp = _tps(corpus)
    bin_path = str(tmp_path / "caps.bin")
    binarize_captions_from_list.main([
        "--file", str(corpus / "list.tsv"), "--output", bin_path,
        "--tok", str(corpus / "tok"), "--lang", "en"])
    (tmp_path / "src.txt").write_text("alpha beta gamma\ndelta zeta\n" * 8)
    (tmp_path / "dst.txt").write_text("beta alpha\nzeta epsi delta\n" * 8)
    write_mt(tp, str(tmp_path / "train.mt"), str(tmp_path / "src.txt"),
             tp.token_id("<en>"), str(tmp_path / "dst.txt"),
             tp.token_id("<fa>"))
    # An MT checkpoint of the CLI's text shapes, grafted by --lm.
    mt_cfg = Seq2SeqConfig(vocab_size=tp.vocab_size(), num_languages=2,
                           hidden_size=48, intermediate_size=96,
                           enc_layers=1, dec_layers=1)
    mt = random_params(mt_cfg, 5)
    ckpt.save_params(str(tmp_path / "mt"), mt_cfg, mt)
    model = str(tmp_path / "model")
    train_captioning.main([
        "--tok", str(corpus / "tok"), "--model", model, "--train", bin_path,
        "--dev", bin_path, "--train_mt", str(tmp_path / "train.mt"),
        "--lm", str(tmp_path / "mt"),
        "--step", "2", "--embed", "48", "--intermediate", "96", "--enc", "1",
        "--dec", "1", "--max-image", "8", "--beam", "2", "--warmup", "2",
        "--pretrained", "unused", "--device", "cpu"])
    params, opt_tree, meta = ckpt.load_checkpoint(model + ".latest",
                                                  with_opt_state=True)
    assert meta["step"] == 2 and opt_tree is not None
    # The text core started from the MT model: two steps of at most ~1e-4
    # each away from it (a fresh draw differs by ~0.02).
    np.testing.assert_allclose(
        params["params"]["embeddings"]["word"]["embedding"].numpy(),
        mt["params"]["embeddings"]["word"]["embedding"], atol=1e-3)
    # The dev BLEU ran at the end of the epoch and saved the best slot.
    assert ckpt.load_checkpoint(model)[2]["best_metric"] >= 0.0
    assert os.path.exists(os.path.join(model, "bleu.caption.output"))
    cfg = ckpt.load_config(model + ".latest")
    assert (cfg.hidden_size, cfg.dtype, cfg.img_size) == (48, "bfloat16", 224)
    caption_cli.main(["--tok", str(corpus / "tok"), "--model",
                      model + ".latest", "--input", str(corpus / "images"),
                      "--output", str(tmp_path / "out.tsv"), "--target",
                      "en", "--max_len", "6", "--beam", "2", "--device",
                      "cpu"])
    rows = (tmp_path / "out.tsv").read_text().splitlines()
    assert len(rows) == 11 and all(r.split("\t")[0].endswith(".jpg")
                                   for r in rows)


@pytest.mark.slow
def test_cli_train_captioning_under_torchrun(corpus, binary, tmp_path):
    """``cli.train_captioning --mesh 2x1`` for two steps and a dev caption
    BLEU under torchrun (BatchNorm over the global batch, the dev decode's
    rows split over the data axis); rank 0 writes the checkpoint and the
    transcript. Slow: one torchrun launch of two ranks (~15 s)."""
    import _torch_port_ranks as ranks

    model = str(tmp_path / "model")
    out = ranks.torchrun(
        2, "imagetranslate_tpu_torch.cli.train_captioning", "--tok",
        str(corpus / "tok"), "--model", model, "--train", binary, "--dev",
        binary, "--step", "2", "--embed", "48", "--intermediate", "96",
        "--enc", "1", "--dec", "1", "--max-image", "8", "--beam", "2",
        "--warmup", "2", "--device", "cpu", "--mesh", "2x1")
    assert out.count("Finished Training!") == 1 and "Captioning BLEU" in out
    params, opt_tree, meta = ckpt.load_checkpoint(model + ".latest",
                                                  with_opt_state=True)
    assert meta["step"] == 2 and opt_tree is not None
    assert os.path.exists(os.path.join(model, "bleu.caption.output"))


def test_cli_defaults_are_the_jax_clis():
    from imagetranslate_tpu.cli.train_captioning import get_parser as jparser
    from imagetranslate_tpu_torch.cli.train_captioning import get_parser

    argv = ["--tok", "t", "--model", "m"]
    got = vars(get_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(jparser().parse_args(argv))


# --mesh is ported: outside torchrun it asks for it. The ids keep the names
# the cases had when it was refused as unported.
@pytest.mark.parametrize("flags, message", [
    (["--mmode", "mixed", "--mesh", "4x2"], "torchrun"),
    (["--mesh", "4x2"], "torchrun"), (["--obj"], "--obj-feats")],
    ids=["flags0-module 14", "flags1-module 14", "flags2---obj-feats"])
def test_cli_refusals(corpus, binary, tmp_path, flags, message):
    from imagetranslate_tpu_torch.cli import train_captioning

    with pytest.raises(SystemExit, match=message):
        train_captioning.main(["--tok", str(corpus / "tok"), "--model",
                               str(tmp_path / "m"), "--train", binary,
                               "--device", "cpu", *flags])
    assert not (tmp_path / "m").exists()


def test_packed_files_and_trainer_options_are_refused(corpus, tmp_path):
    from imagetranslate_tpu_torch.cli import (
        binarize_captions_from_list,
        binarize_coco_data,
        binarize_image_caption_data,
    )

    _, tp = _tps(corpus)
    # Packed caption binaries (ITR1 + .paths.json) are written and read as
    # the marshal ones (byte for byte against the JAX CLIs:
    # tests/test_torch_port_recordio.py).
    pbin.write_from_list(tp, str(tmp_path / "m.bin"),
                         str(corpus / "list.tsv"))
    pbin.write_from_list(tp, str(tmp_path / "p.bin"),
                         str(corpus / "list.tsv"), packed=True)
    assert (tmp_path / "p.bin").read_bytes()[:4] == b"ITR1"
    assert pimages.load_caption_bin(str(tmp_path / "p.bin")) == \
        pimages.load_caption_bin(str(tmp_path / "m.bin"))
    assert pimages.CaptionEvalSet(str(tmp_path / "p.bin"), tp).max_len == \
        pimages.CaptionEvalSet(str(tmp_path / "m.bin"), tp).max_len
    binarize_captions_from_list.main([
        "--file", str(corpus / "list.tsv"), "--output",
        str(tmp_path / "cli.bin"), "--tok", str(corpus / "tok"), "--packed"])
    assert (tmp_path / "cli.bin").read_bytes() == \
        (tmp_path / "p.bin").read_bytes()
    for mod in (binarize_coco_data, binarize_image_caption_data):
        with pytest.raises(FileNotFoundError):
            mod.main(["--file", str(tmp_path / "missing.json"), "--output",
                      str(tmp_path / "o"), "--tok", str(corpus / "tok"),
                      "--packed"])
    assert not (tmp_path / "o").exists()
    _, cfg = _cfgs()
    # The multimodal streams are taken (tests/test_torch_port_image_mt.py).
    assert CaptionTrainer(cfg, tp, mm_mode="mixed",
                          device="cpu").mm_mode == "mixed"
    # A mesh is taken (tests/test_torch_port_mesh_image.py); one of a
    # single rank splits nothing and writes.
    from imagetranslate_tpu_torch.parallel.mesh import ProcessMesh

    one = CaptionTrainer(cfg, tp, mesh=ProcessMesh(1, 1), device="cpu")
    assert one.chief and not any(one.plan.values())
