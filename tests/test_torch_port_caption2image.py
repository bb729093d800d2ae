"""The port's Caption2Image (models/caption2image.py), its train step,
``Caption2ImageTrainer``, ``cli.train_txt2image`` and ``cli.translate_img``
against the JAX package's.

The same weights (``weights.CAPTION2IMAGE.random_params`` and
``weights.CAPTION.random_params``, numpy) and the same numpy batches go
through both packages, fp32, a 2-layer text encoder at E=48, dropout 0, the
frozen captioner's ResNet-18 at 224 pixels (its 7 x 7 grid is what the 49
slots regress onto):

- the grid within 1e-4, padding tokens and rows included;
- the regression loss and its gradient over every parameter within
  1e-6 + rtol 1e-4, then a 3-step SGD trajectory of
  ``make_caption2image_train_step`` (losses to rtol 1e-5, parameters within
  1e-6 + rtol 1e-4, the row counts equal);
- the trainers' target grids (the frozen captioner's ``encode_images`` in
  inference mode, staged by the trainer) within 1e-4 and their dev losses
  within rtol 1e-4, on the same caption batches of JPEGs;
- a checkpoint with its Adam state crossing both ways;
- ``cli.train_txt2image`` (2 steps from a captioner checkpoint, a dev set);
  ``cli.translate_img`` of the port and of the JAX package on the same
  checkpoints (beam 4, ``ref_ties``): the same three rounds, token for
  token, in the same file; the ``--mesh`` refusal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagetranslate_tpu.models.caption2image import (
    Caption2Image as JaxCaption2Image,
)
from imagetranslate_tpu.models.captioning import ImageSeq2Seq as JaxCaptioner
from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.train import checkpoint as jckpt
from imagetranslate_tpu.train import step as jstep
from imagetranslate_tpu.train.trainer_txt2image import (
    Caption2ImageTrainer as JaxCaption2ImageTrainer,
)
from imagetranslate_tpu_torch.data import binarize_captions as pbin
from imagetranslate_tpu_torch.data.images import CaptionBatcher
from imagetranslate_tpu_torch.models.caption2image import (
    GRID_SLOTS,
    Caption2Image,
)
from imagetranslate_tpu_torch.models.captioning import ImageSeq2Seq
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.text.processor import TextProcessor
from imagetranslate_tpu_torch.train import checkpoint as ckpt
from imagetranslate_tpu_torch.train import step as pstep
from imagetranslate_tpu_torch.train.trainer_txt2image import (
    Caption2ImageTrainer,
)
from imagetranslate_tpu_torch.train.weights import (
    CAPTION,
    CAPTION2IMAGE,
    opt_state_from_flax,
)

V, B, S, E = 48, 6, 10, 48
WIDTH = dict(hidden_size=E, num_heads=4, intermediate_size=96, enc_layers=2,
             dec_layers=2)
IMG = 224
OPT = dict(lr=1e-3, warmup_updates=4, clip_norm=1.0)
SGD_LR = 0.02
WORDS = ["alpha", "beta", "gamma", "delta", "epsi", "zeta", "theta"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: fastest at these sizes, and steady when other
    test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, padded=True):
    rng = np.random.RandomState(seed)
    src = rng.randint(5, V, (B, S)).astype(np.int32)
    lengths = rng.randint(3, S + 1, B)
    lengths[0] = S
    src = np.where(np.arange(S)[None, :] < lengths[:, None], src,
                   0).astype(np.int32)
    row_mask = np.ones(B, bool)
    if padded:
        row_mask[-1] = False
    return {"src": src, "src_mask": src != 0, "src_langs": np.zeros(B, np.int32),
            "target_grid": rng.randn(B, GRID_SLOTS, E).astype(np.float32)
            * 0.05, "row_mask": row_mask}


def _torch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _port(cfg, params):
    model = Caption2Image(cfg, param_dtype=torch.float32)
    model.load_state_dict(CAPTION2IMAGE.state_dict_from_flax(params, cfg),
                          strict=True)
    return model


def _assert_close(sd, tree, cfg, atol=1e-6, rtol=1e-4):
    want = CAPTION2IMAGE.state_dict_from_flax(jax.device_get(tree), cfg)
    assert set(sd) == set(want)
    for name, leaf in sd.items():
        np.testing.assert_allclose(leaf.detach().numpy(), want[name].numpy(),
                                   atol=atol, rtol=rtol, err_msg=name)


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
    """An optimizer that keeps the gradients it is handed (by name)."""
    chain = ()

    def init(self, params):
        return None

    def update(self, grads, state, params):
        self.grads = dict(zip(params, grads))


def _jax_loss(jm, params, b):
    """The JAX step's objective (train/step.py:343-353) at dropout 0."""
    grid = jm.apply(params, b["src"], b["src_mask"], b["src_langs"])
    per_row = jnp.sum((grid - b["target_grid"]) ** 2, axis=(1, 2))
    return jnp.sum(per_row * b["row_mask"]) / jnp.maximum(
        jnp.sum(b["row_mask"]), 1.0)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(vocab_size=V, **WIDTH)
    jcfg = jax_tiny_config(vocab_size=V, **WIDTH)
    params = CAPTION2IMAGE.random_params(cfg, 0)
    jm = JaxCaption2Image(jcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    b = _batch(0)

    @jax.jit
    def run(p):
        return (jm.apply(p, b["src"], b["src_mask"], b["src_langs"]),
                jax.value_and_grad(lambda q: _jax_loss(jm, q, b))(p))

    grid, loss_grad = jax.device_get(run(jparams))
    return dict(cfg=cfg, jcfg=jcfg, params=params, jm=jm, jparams=jparams,
                grid=grid, loss_grad=loss_grad)


def test_grid_matches_flax(setup):
    model = _port(setup["cfg"], setup["params"])
    b = _torch(_batch(0))
    with torch.no_grad():
        grid = model(b["src"], b["src_mask"], b["src_langs"])
    assert grid.shape == (B, GRID_SLOTS, E) and grid.dtype == torch.float32
    np.testing.assert_allclose(grid.numpy(), setup["grid"], atol=1e-4)
    # The grid head stays fp32 in a bf16 model built for serving.
    bf16 = Caption2Image(tiny_config(vocab_size=V, dtype="bfloat16",
                                     **WIDTH))
    assert bf16.decoder.weight.dtype == torch.float32
    assert bf16.input_attention.w.weight.dtype == torch.bfloat16


def _zero_gradient(name):
    """The pool's score bias and the attention key biases: a softmax is
    invariant to them, so their gradient is zero but for rounding (~1e-6 at
    this loss's scale), compared as such."""
    return name == "input_attention.w.bias" or name.endswith(".key.bias")


def test_loss_and_gradient_match_jax(setup):
    cfg = setup["cfg"]
    model = _port(cfg, setup["params"])
    rec = _Recording()
    state = pstep.create_train_state(dict(model.named_parameters()), rec)
    step = pstep.make_caption2image_train_step(model, rec)
    state, m = step(state, _torch(_batch(0)), torch.Generator())
    want_loss, want_grads = setup["loss_grad"]
    assert float(m["ntokens"]) == B - 1
    np.testing.assert_allclose(float(m["sum_loss"] / m["ntokens"]),
                               float(want_loss), atol=1e-6, rtol=1e-4)
    want = CAPTION2IMAGE.state_dict_from_flax(want_grads, cfg)
    for name, g in rec.grads.items():
        assert torch.isfinite(g).all(), name
        if _zero_gradient(name):
            assert max(g.abs().max(), want[name].abs().max()) < 1e-5, name
            continue
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-6,
                                   rtol=1e-4, err_msg=name)


def test_three_step_sgd_trajectory_matches_jax(setup):
    cfg = setup["cfg"]
    model = _port(cfg, setup["params"])
    optim = _SGD(SGD_LR)
    state = pstep.create_train_state(dict(model.named_parameters()), optim)
    step = pstep.make_caption2image_train_step(model, optim)
    jsgd = optax.sgd(SGD_LR)
    jstate = jstep.create_train_state(setup["jparams"], jsgd)
    jfn = jstep.make_caption2image_train_step(setup["jm"], jsgd,
                                              donate=False)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for i in range(3):
        b = _batch(10 + i)
        jstate, jm_ = jfn(jstate, b, jax.random.PRNGKey(i))
        state, m = step(state, _torch(b), gen)
        assert float(m["ntokens"]) == float(jm_["ntokens"]) == B - 1
        np.testing.assert_allclose(float(m["sum_loss"]),
                                   float(jm_["sum_loss"]), rtol=1e-5)
        losses.append(float(m["sum_loss"]))
        _assert_close(model.state_dict(), jstate.params, cfg)
    assert state.step == 3 and losses[0] != losses[2]


# ---------------- the trainers ----------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A tokenizer (<en>, <fa>), JPEGs, train and dev caption binaries, the
    lines to translate, and a captioner checkpoint (ResNet-18 at 224, random
    weights and statistics, a wide initializer so that decodes depend on
    their input)."""
    from PIL import Image

    from imagetranslate_tpu_torch.train.checkpoint import save_checkpoint

    d = tmp_path_factory.mktemp("c2i")
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
    for i in range(4):
        yy, xx = np.mgrid[0:80 + 8 * i, 0:96].astype(np.float32)
        arr = np.stack([127 + 120 * np.sin(xx / (5 + c + i) + yy / 9)
                        for c in range(3)], -1).astype(np.uint8)
        Image.fromarray(arr).save(img / f"{i:02d}.jpg")
    for name, n in (("train", 10), ("dev", 5)):
        lines = [f"{img}/{i % 4:02d}.jpg\t{sentence(rng.randint(2, 9))}"
                 for i in range(n)]
        (d / f"{name}.tsv").write_text("\n".join(lines) + "\n")
        pbin.write_from_list(tp, str(d / f"{name}.bin"),
                             str(d / f"{name}.tsv"), lang="en")
    (d / "input.en").write_text("\n".join(sentence(rng.randint(1, 7))
                                          for _ in range(9)) + "\n")
    cap_cfg = tiny_config(vocab_size=tp.vocab_size(), img_size=IMG,
                          resnet_depth=1, initializer_range=0.15, **WIDTH)
    save_checkpoint(str(d / "captioner"), cap_cfg,
                    CAPTION.random_params(cap_cfg, 5))
    c2i_cfg = tiny_config(vocab_size=tp.vocab_size(),
                          initializer_range=0.15, **WIDTH)
    save_checkpoint(str(d / "c2i"), c2i_cfg,
                    CAPTION2IMAGE.random_params(c2i_cfg, 6))
    return d


@pytest.fixture(scope="module")
def trainers(setup, corpus):
    """The two packages' trainers on the same Caption2Image weights and the
    same frozen captioner."""
    from imagetranslate_tpu_torch.cli.caption import load_captioner

    tp = TextProcessor(str(corpus / "tok"))
    cfg = tiny_config(vocab_size=tp.vocab_size(), **WIDTH)
    jcfg = jax_tiny_config(vocab_size=tp.vocab_size(), **WIDTH)
    params = CAPTION2IMAGE.random_params(cfg, 1)
    captioner = load_captioner(str(corpus / "captioner"), "cpu")
    port = Caption2ImageTrainer(cfg, tp, captioner, params=params,
                                lr=OPT["lr"], warmup=OPT["warmup_updates"],
                                device="cpu")
    cap_cfg = ckpt.load_config(str(corpus / "captioner"))
    cap_vars = jax.tree.map(jnp.asarray, CAPTION.random_params(cap_cfg, 5))
    jcap_cfg = jax_tiny_config(vocab_size=tp.vocab_size(), img_size=IMG,
                               resnet_depth=1, initializer_range=0.15,
                               **WIDTH)
    jtr = JaxCaption2ImageTrainer(jcfg, tp, JaxCaptioner(jcap_cfg), cap_vars,
                                  lr=OPT["lr"],
                                  warmup=OPT["warmup_updates"])
    jtr.state = jstep.create_train_state(jax.tree.map(jnp.asarray, params),
                                         jtr.optimizer)
    return dict(tp=tp, cfg=cfg, jcfg=jcfg, port=port, jax=jtr)


def test_trainer_targets_and_eval_match_jax(corpus, trainers, tmp_path):
    tp, port, jtr = trainers["tp"], trainers["port"], trainers["jax"]
    dev = CaptionBatcher(str(corpus / "dev.bin"), tp, max_img_per_batch=4)
    assert [int(b.row_mask.sum()) for b in dev] == [4, 1]
    for b in dev:
        got, want = port._batch(b, ""), jtr._batch(b, "")
        assert got["target_grid"].shape == (b.captions.shape[0], GRID_SLOTS,
                                            E)
        np.testing.assert_allclose(got["target_grid"].numpy(),
                                   np.asarray(want["target_grid"]),
                                   atol=1e-4)
    jtr.best_loss = port.best_loss = float("inf")
    want = jtr.eval(dev, "", str(tmp_path / "jax"))
    got = port.eval(dev, "", str(tmp_path / "port"))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert port.best_loss == got and (tmp_path / "port" / "meta.json").exists()
    # An equal dev loss does not save (<).
    port.eval(dev, "", str(tmp_path / "port2"))
    assert not (tmp_path / "port2").exists()


def test_checkpoint_crosses_both_ways(setup, corpus, trainers, tmp_path):
    """Two Adam steps of the port's trainer, saved; the JAX package loads
    params and optimizer state into its templates (equal leaves); what JAX
    saves loads back into the port (equal weights and moments), and both
    take the same next step."""
    cfg, port, jtr = trainers["cfg"], trainers["port"], trainers["jax"]
    tp = trainers["tp"]
    train = list(CaptionBatcher(str(corpus / "train.bin"), tp,
                                max_img_per_batch=4))
    for b in train[:2]:
        port.state, _ = port.step_fn(port.state, port._batch(b, ""),
                                     port.rng)
    port.best_loss = 7.0
    port._save(str(tmp_path / "port"), 2)
    params, opt_state, meta = jckpt.load_checkpoint(
        str(tmp_path / "port"), jax.tree.map(jnp.zeros_like, jtr.state.params),
        jax.tree.map(jnp.zeros_like, jtr.state.opt_state))
    assert meta == {"step": 2, "best_metric": 7.0}
    _assert_close(port.model.state_dict(), params, cfg, atol=0, rtol=0)
    jckpt.save_checkpoint(str(tmp_path / "jax"), trainers["jcfg"], params,
                          opt_state=opt_state, step=2)
    tree, opt_tree, meta = ckpt.load_checkpoint(str(tmp_path / "jax"),
                                                with_opt_state=True)
    back = Caption2ImageTrainer(cfg, tp, port.caption_model, device="cpu",
                                lr=OPT["lr"], warmup=OPT["warmup_updates"])
    back.set_reference_params(tree, meta["step"])
    back.state.opt_state = opt_state_from_flax(opt_tree, back.optimizer, cfg,
                                               bridge=CAPTION2IMAGE)
    for name, p in port.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[name], p), name
    a, c = port.state.opt_state, back.state.opt_state
    assert (a.count, a.schedule_count) == (c.count, c.schedule_count) == (2, 2)
    for name in a.mu:
        assert torch.equal(a.mu[name], c.mu[name]), name
        assert torch.equal(a.nu[name], c.nu[name]), name
    nxt = port._batch(train[2], "")
    port.state, m1 = port.step_fn(port.state, nxt, port.rng)
    back.state, m2 = back.step_fn(back.state, nxt, back.rng)
    assert torch.equal(m1["sum_loss"], m2["sum_loss"])


# ---------------- the CLIs ----------------

def test_cli_train_txt2image(corpus, tmp_path):
    from imagetranslate_tpu_torch.cli import train_txt2image

    model = tmp_path / "m"
    base = ["--tok", str(corpus / "tok"), "--model", str(model),
            "--pretrained", str(corpus / "captioner"), "--train",
            str(corpus / "train.bin"), "--embed", "48", "--intermediate",
            "96", "--enc", "1", "--max-image", "4", "--warmup", "2",
            "--dtype", "float32", "--device", "cpu"]
    # --mesh is ported: outside torchrun it asks for it.
    with pytest.raises(SystemExit, match="torchrun"):
        train_txt2image.main(base + ["--step", "1", "--mesh", "2x1"])
    assert not model.exists()
    train_txt2image.main(base + ["--step", "2", "--dev",
                                 str(corpus / "dev.bin")])
    _, opt_tree, meta = ckpt.load_checkpoint(str(model) + ".latest",
                                             with_opt_state=True)
    assert meta["step"] == 2 and opt_tree is not None
    assert ckpt.load_checkpoint(str(model))[2]["step"] in (1, 2)   # best
    cfg = ckpt.load_config(str(model))
    assert (cfg.hidden_size, cfg.enc_layers) == (48, 1)


@pytest.mark.slow
def test_cli_train_txt2image_under_torchrun(corpus, tmp_path):
    """``cli.train_txt2image --mesh 2x1`` for two steps under torchrun: each
    rank encodes the target grids of its own rows with the frozen
    captioner; rank 0 writes the one-device checkpoint. Slow: one torchrun
    launch of two ranks (~10 s)."""
    import _torch_port_ranks as ranks

    model = tmp_path / "m"
    out = ranks.torchrun(
        2, "imagetranslate_tpu_torch.cli.train_txt2image", "--tok",
        str(corpus / "tok"), "--model", str(model), "--pretrained",
        str(corpus / "captioner"), "--train", str(corpus / "train.bin"),
        "--embed", "48", "--intermediate", "96", "--enc", "1", "--max-image",
        "4", "--warmup", "2", "--dtype", "float32", "--device", "cpu",
        "--step", "2", "--mesh", "2x1")
    assert out.count("Finished Training!") == 1
    _, opt_tree, meta = ckpt.load_checkpoint(str(model) + ".latest",
                                             with_opt_state=True)
    assert meta["step"] == 2 and opt_tree is not None


@pytest.mark.parametrize("verbose", [False, True])
def test_cli_translate_img_matches_jax(corpus, tmp_path, verbose):
    """Both CLIs on the same Caption2Image and captioner checkpoints: the
    three rounds of every line, token for token."""
    from imagetranslate_tpu.cli import translate_img as jax_translate_img
    from imagetranslate_tpu_torch.cli import translate_img

    args = ["--tok", str(corpus / "tok"), "--model", str(corpus / "c2i"),
            "--caption-model", str(corpus / "captioner"), "--input",
            str(corpus / "input.en"), "--src", "en", "--target", "fa",
            "--batch", "160"] + (["--verbose"] if verbose else [])
    translate_img.main(args + ["--output", str(tmp_path / "port.txt"),
                               "--device", "cpu"])
    jax_translate_img.main(args + ["--output", str(tmp_path / "jax.txt")])
    got = (tmp_path / "port.txt").read_text()
    assert got == (tmp_path / "jax.txt").read_text()
    lines = got.splitlines()
    assert len(lines) == 9
    cols = [line.split(" ||| ") for line in lines]
    assert all(len(c) == (4 if verbose else 3) for c in cols)
    # The decodes depend on their input: the rounds are not all alike.
    assert len({c[0] for c in cols}) > 1
