"""The image families under a mesh (ROADMAP module 14b, part 4): the
captioner's BatchNorm, caption and contrastive steps, SenSim, Caption2Image
and ``ImageMTTrainer`` over ``torch.distributed``, fp32, dropout 0, one spawn
of four ranks over gloo on the CPU (a 2 x 1 case runs on ranks 0 and 1).
The same flax-layout variables (the bridges' ``random_params``) and the
same global numpy batches go through every arm; steps under plain SGD, so
that a parameter's change is its gradient.

- BatchNorm in training mode at 2 x 1: the running statistics (from the
  global batch's mean and biased variance) within 1e-5 of one process, and
  the grid of each rank's rows within 5e-5: the grid passes twenty
  training-mode BatchNorms, each of which turns a last-bit difference of a
  variance into a difference of the next layer's input, and two fp32 forms
  of the same statistics part by 1.5e-5 there (fp64-accumulated statistics
  against ``torch.var``'s, both on one process);
- the caption step at 2 x 2 (the text core's heads, FFN and vocab split)
  against JAX ``make_caption_train_step`` on the global batch: the loss to
  rtol 1e-4, parameters and statistics within 1e-5 (as the one-process
  trajectory test holds them);
- the contrastive step at 2 x 1 with ``freeze_image`` (the trained tower is
  rounding-bound, ROADMAP queue 3): the text vectors and the negatives
  gathered over the data group; SenSim with both negative pools and
  Caption2Image at 2 x 1: each against one process (loss rtol 1e-5,
  parameters within 1e-6 + rtol 1e-5);
- ``ImageMTTrainer`` at 2 x 1 under ZeRO-1 (its layout's ``min_size``
  lowered so that the tiny model's tensors split) against the same mesh
  without it, over an MT, a text MASS, a multimodal MASS and a contrastive
  step (negatives the data axis does not divide, so they stay whole), with
  ``freeze_image`` (under Adam the trained tower's steps part at the
  rounding of its gradients, as tests/test_torch_port_caption_train.py
  sets out; the SGD cases above hold its gradients): the
  losses, parameters and gathered first moments equal to rtol 1e-5 (and
  within 1e-4 lr and 1e-9 where they are near 0: the clip's norm sums the
  squares in another order, and Adam turns a last-bit difference of a
  gradient at the level of its epsilon into a fraction of a step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagetranslate_tpu.models.captioning import ImageSeq2Seq as JaxModel
from imagetranslate_tpu.train import step as jstep
from imagetranslate_tpu_torch.models.caption2image import Caption2Image
from imagetranslate_tpu_torch.models.captioning import ImageSeq2Seq
from imagetranslate_tpu_torch.models.config import (
    Seq2SeqConfig,
    tiny_config,
)
from imagetranslate_tpu_torch.models.sensim import SenSim
from imagetranslate_tpu_torch.parallel.spawn import run_ranks
from imagetranslate_tpu_torch.train import step as pstep
from imagetranslate_tpu_torch.train.weights import (
    CAPTION,
    CAPTION2IMAGE,
    SENSIM,
)

import _torch_port_ranks as ranks

V, IMG, B, T = 40, 64, 4, 7
LR = 0.5
OPT = dict(lr=1e-3, warmup=1, clip=0.05)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _caption_batch(seed, rows=B, negs=6):
    rng = np.random.RandomState(seed)
    caps = rng.randint(5, V, (rows, T)).astype(np.int32)
    for i in range(rows):
        caps[i, rng.randint(3, T + 1):] = 0
    row_mask = np.ones(rows, bool)
    row_mask[-1] = False
    neg = rng.randint(5, V, (negs, T)).astype(np.int32)
    neg[:, 5:] = 0
    return {"images": rng.randint(0, 256, (rows, IMG, IMG, 3)).astype(
                np.uint8),
            "captions": caps, "caption_mask": caps != 0,
            "langs": np.zeros(rows, np.int32), "row_mask": row_mask,
            "lengths": (caps != 0).sum(1).astype(np.int32),
            "neg": neg, "neg_mask": neg != 0,
            "neg_langs": np.zeros(negs, np.int32)}


def _text(rng, rows, width):
    ids = rng.randint(5, V, (rows, width)).astype(np.int32)
    for i in range(rows):
        ids[i, rng.randint(3, width + 1):] = 0
    return ids


def _sensim_batch(seed):
    rng = np.random.RandomState(seed)
    src, dst = _text(rng, B, 8), _text(rng, B, 6)
    out = {"src": src, "src_mask": src != 0, "dst": dst, "dst_mask": dst != 0,
           "src_langs": np.zeros(B, np.int32),
           "dst_langs": np.ones(B, np.int32),
           "row_mask": np.array([True, True, True, False])}
    for prefix, lang in (("src_neg", 0), ("tgt_neg", 1)):
        pool = _text(rng, 6, 5)
        out.update({prefix: pool, f"{prefix}_mask": pool != 0,
                    f"{prefix}_langs": np.full(6, lang, np.int32),
                    f"{prefix}_row_mask": np.arange(6) < 5})
    return out


def _c2i_batch(seed, E):
    rng = np.random.RandomState(seed)
    src = _text(rng, B, 8)
    return {"src": src, "src_mask": src != 0,
            "src_langs": np.zeros(B, np.int32),
            "target_grid": rng.standard_normal((B, 49, E)).astype(
                np.float32),
            "row_mask": np.array([True, True, False, True])}


def _cfgs():
    cfg = tiny_config(vocab_size=V, img_size=IMG)
    return cfg, dataclasses.replace(cfg, freeze_image=True)


@pytest.fixture(scope="module")
def setup():
    cfg, frozen = _cfgs()
    variables = CAPTION.random_params(cfg, 0)
    scfg = tiny_config(vocab_size=V)
    return dict(cfg=cfg, frozen=frozen, variables=variables, scfg=scfg,
                sparams=SENSIM.random_params(scfg, 1),
                cparams=CAPTION2IMAGE.random_params(scfg, 2),
                cap=_caption_batch(0), sensim=_sensim_batch(1),
                c2i=_c2i_batch(2, scfg.hidden_size))


CASES = ["bn-2x1", "caption-2x2", "contrastive-2x1", "sensim-2x1",
         "c2i-2x1"]


def _cases(s):
    cap = s["cap"]
    return [
        ("bn", s["cfg"], s["variables"], {"images": cap["images"]}, (2, 1)),
        ("caption", s["cfg"], s["variables"],
         {k: cap[k] for k in ("images", "captions", "caption_mask", "langs",
                              "row_mask")}, (2, 2)),
        ("contrastive", s["frozen"], s["variables"], cap, (2, 1)),
        ("sensim", s["scfg"], s["sparams"], s["sensim"], (2, 1)),
        ("c2i", s["scfg"], s["cparams"], s["c2i"], (2, 1)),
    ]


def _mt_batches(s):
    rng = np.random.RandomState(7)
    src, dst = _text(rng, B, 9), _text(rng, B, T)
    mt = {"src": src, "src_mask": src != 0, "dst": dst, "dst_mask": dst != 0,
          "src_langs": np.zeros(B, np.int32),
          "dst_langs": np.ones(B, np.int32), "row_mask": np.ones(B, bool)}
    mono = _text(rng, B, 10)
    mass = {"src": mono, "src_mask": mono != 0,
            "langs": np.zeros(B, np.int32),
            "lang_tokens": np.full(B, 5, np.int32),
            "lengths": (mono != 0).sum(1).astype(np.int32),
            "row_mask": np.ones(B, bool)}
    cap = _caption_batch(8, negs=5)
    mm = {k: cap[k] for k in ("images", "captions", "caption_mask", "langs",
                              "row_mask", "lengths")}
    mm["mask_prob"] = 0.7
    return [("mt", mt), ("mass", mass), ("mm", mm), ("contrastive", cap)]


@pytest.fixture(scope="module")
def port(setup, tmp_path_factory):
    """One spawn of four ranks: the five cases, then ImageMTTrainer with and
    without ZeRO."""
    store = tmp_path_factory.mktemp("image")
    got = run_ranks(ranks.image_mesh, 4, str(store / "a"),
                    (_cases(setup), LR))
    cases = {name: [r[i] for r in got if r[i] is not None]
             for i, name in enumerate(CASES)}
    zero = run_ranks(ranks.image_mt_zero, 4, str(store / "b"),
                     (setup["frozen"], setup["variables"],
                      _mt_batches(setup), OPT))
    return cases, zero[0]


def _one_process(kind, cfg, variables, batch):
    """The port's step in one process under SGD: ((sum, n), state dict)
    ("bn": (grid, state dict))."""
    if kind in ("sensim", "c2i"):
        cls, bridge = ((SenSim, SENSIM) if kind == "sensim"
                       else (Caption2Image, CAPTION2IMAGE))
        model = cls(cfg, param_dtype=torch.float32)
        model.load_state_dict(bridge.state_dict_from_flax(variables, cfg))
        state = pstep.create_train_state(dict(model.named_parameters()),
                                         ranks.SGD(LR))
    else:
        model = ImageSeq2Seq(cfg, param_dtype=torch.float32)
        model.load_state_dict(CAPTION.state_dict_from_flax(variables, cfg))
        state = pstep.create_caption_train_state(model, ranks.SGD(LR))
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    if kind == "bn":
        with torch.no_grad():
            grid = model.encode_images(tb["images"], train=True)
        return grid.numpy(), ranks._np(model.state_dict())
    make = {"caption": pstep.make_caption_train_step,
            "contrastive": pstep.make_contrastive_step,
            "sensim": pstep.make_sensim_train_step,
            "c2i": pstep.make_caption2image_train_step}[kind]
    _, m = make(model.train(), ranks.SGD(LR))(
        state, tb, torch.Generator().manual_seed(0))
    return ((float(m["sum_loss"]), float(m["ntokens"])),
            ranks._np(model.state_dict()))


def _assert_sd(got, want, atol, rtol=0.0):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def test_batchnorm_takes_the_global_batch_statistics(setup, port):
    grid, sd = _one_process("bn", setup["cfg"], setup["variables"],
                            _cases(setup)[0][3])
    out = port[0]["bn-2x1"]
    assert len(out) == 2
    got = np.concatenate([r[2] for r in sorted(out, key=lambda r: r[1])])
    np.testing.assert_allclose(got, grid, atol=5e-5)
    stats = {k: v for k, v in sd.items() if "running_" in k}
    assert stats
    _assert_sd({k: out[0][3][k] for k in stats}, stats, atol=1e-5)
    # Not the statistics of one rank's rows alone.
    half = _one_process("bn", setup["cfg"], setup["variables"],
                        {"images": setup["cap"]["images"][:2]})[1]
    assert max(np.abs(half[k] - stats[k]).max() for k in stats) > 1e-3


def test_caption_step_at_2x2_matches_jax(setup, port):
    cfg, batch = setup["cfg"], _cases(setup)[1][3]
    jcfg = Seq2SeqConfig.from_json(cfg.to_json())
    from imagetranslate_tpu.models.config import Seq2SeqConfig as JaxConfig

    jm = JaxModel(JaxConfig.from_json(jcfg.to_json()))
    sgd = optax.sgd(LR)
    jstate = jstep.create_caption_train_state(
        jax.tree.map(jnp.asarray, setup["variables"]), sgd)
    jstate, m = jstep.make_caption_train_step(jm, sgd, donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    loss = float(m["sum_loss"]) / float(m["ntokens"])
    want = ranks._np(CAPTION.state_dict_from_flax(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}), cfg))
    out = port[0]["caption-2x2"]
    assert len(out) == 4
    for (sum_l, n), *_ in out:
        assert n == float(m["ntokens"])
        np.testing.assert_allclose(sum_l / n, loss, rtol=1e-4)
    _assert_sd(out[0][3], want, atol=1e-5)


@pytest.mark.parametrize("case", CASES[2:])
def test_step_at_2x1_equals_one_process(setup, port, case):
    kind = case.split("-")[0]
    _, cfg, variables, batch, _ = _cases(setup)[CASES.index(case)]
    (sum_l, n), want = _one_process(kind, cfg, variables, batch)
    out = port[0][case]
    assert len(out) == 2
    for (got_sum, got_n), *_ in out:
        assert got_n == n
        np.testing.assert_allclose(got_sum, sum_l, rtol=1e-5)
    _assert_sd(out[0][3], want, atol=1e-6, rtol=1e-5)
    if kind == "contrastive":
        assert all(np.array_equal(out[0][3][k], want[k]) for k in want
                   if k.startswith("image_model.") and "running_" not in k)


def test_image_mt_trainer_zero_equals_no_zero(port):
    plain, zero = port[1]
    assert plain[1] == 0 < zero[1]
    np.testing.assert_allclose(zero[0], plain[0], rtol=1e-5)
    assert plain[0][0] != plain[0][1]
    for k in plain[2]:
        # Softmax does not see these biases (attention keys, the pools'
        # scores): their gradients are rounding noise, and an Adam step of
        # noise is anything up to lr.
        noise = k.endswith((".self.key.bias", "attention.w.bias"))
        np.testing.assert_allclose(
            zero[2][k], plain[2][k], rtol=1e-5,
            atol=(len(plain[0]) if noise else 1e-4) * OPT["lr"], err_msg=k)
    for k in plain[3]:
        np.testing.assert_allclose(zero[3][k], plain[3][k], rtol=1e-5,
                                   atol=1e-9, err_msg=k)
