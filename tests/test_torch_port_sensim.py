"""The port's sentence-similarity model (models/sensim.py), its train step,
``SenSimTrainer`` and the CLIs ``train_sensim`` / ``get_sen_sim`` against the
JAX package's.

The same weights (``weights.SENSIM.random_params``, numpy) and the same numpy
batches go through both packages, fp32, 2 encoder layers at E=48, dropout 0:

- ``encode``, ``similarity`` and the InfoNCE loss within 1e-4, with in-batch
  negatives and with the negative pools, with and without padding rows (of
  the batch and of each pool);
- the loss's gradient over every parameter within 1e-6 + rtol 1e-4, then a
  3-step SGD trajectory of ``make_sensim_train_step`` (losses to rtol 1e-5,
  parameters within 1e-6 + rtol 1e-4, the row-count metrics equal);
- the trainers' dev loss and ``similarities`` on the same dev batches, and a
  checkpoint with its Adam state crossing both ways (the best-slot save of
  ``eval`` written by each package, read by the other);
- ``cli.train_sensim`` (2 steps, negative pools from MASS shards, a dev
  set) -> ``cli.get_sen_sim`` in the port, beside the JAX ``get_sen_sim``
  on the port's checkpoint: the same pairs, scores within 1e-5;
  ``--pretrained`` and the ``--mesh`` refusal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.models.sensim import SenSim as JaxSenSim
from imagetranslate_tpu.train import checkpoint as jckpt
from imagetranslate_tpu.train import optimizer as jopt
from imagetranslate_tpu.train import step as jstep
from imagetranslate_tpu.train.trainer_sensim import (
    SenSimTrainer as JaxSenSimTrainer,
)
from imagetranslate_tpu_torch.data.loader import MTBatcher
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.models.sensim import SenSim
from imagetranslate_tpu_torch.text.processor import TextProcessor
from imagetranslate_tpu_torch.train import checkpoint as ckpt
from imagetranslate_tpu_torch.train import step as pstep
from imagetranslate_tpu_torch.train.trainer_sensim import SenSimTrainer
from imagetranslate_tpu_torch.train.weights import (
    SENSIM,
    opt_state_from_flax,
)

V, B, S, T, NP = 48, 8, 10, 12, 6
WIDTH = dict(vocab_size=V, hidden_size=48, num_heads=4, intermediate_size=96,
             enc_layers=2, dec_layers=2)
OPT = dict(lr=1e-3, warmup_updates=4, clip_norm=1.0)
SGD_LR = 0.5
WORDS = ["alpha", "beta", "gamma", "delta", "epsi", "zeta", "theta"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: fastest at these sizes, and steady when other
    test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(rng, n, L, lang_tok=None):
    """[n, L] ids padded to random lengths (row 0 full)."""
    ids = rng.randint(5, V, (n, L)).astype(np.int32)
    lengths = rng.randint(3, L + 1, n)
    lengths[0] = L
    if lang_tok is not None:
        ids[:, 0] = lang_tok
    return np.where(np.arange(L)[None, :] < lengths[:, None], ids,
                    0).astype(np.int32)


def _batch(seed, pools=True, padded=True):
    rng = np.random.RandomState(seed)
    src, dst = _rows(rng, B, S), _rows(rng, B, T)
    row_mask = np.ones(B, bool)
    if padded:
        row_mask[-2:] = False
    b = {"src": src, "src_mask": src != 0, "src_langs": np.zeros(B, np.int32),
         "dst": dst, "dst_mask": dst != 0, "dst_langs": np.ones(B, np.int32),
         "row_mask": row_mask}
    if pools:
        for prefix, lang in (("src_neg", 0), ("tgt_neg", 1)):
            neg = _rows(rng, NP, 9)
            keep = np.ones(NP, bool)
            if padded:
                keep[-1 - lang:] = False
            b.update({prefix: neg, f"{prefix}_mask": neg != 0,
                      f"{prefix}_langs": np.full(NP, lang, np.int32),
                      f"{prefix}_row_mask": keep})
    return b


def _torch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


_ARGS = ("src", "src_mask", "src_langs", "dst", "dst_mask", "dst_langs",
         "src_neg", "src_neg_mask", "src_neg_langs", "tgt_neg",
         "tgt_neg_mask", "tgt_neg_langs")
_KW = ("row_mask", "src_neg_row_mask", "tgt_neg_row_mask")


def _call(b):
    """(positional, keyword) arguments of the loss for batch dict ``b``."""
    return [b.get(k) for k in _ARGS], {k: b.get(k) for k in _KW}


def _port(cfg, params):
    model = SenSim(cfg, param_dtype=torch.float32)
    model.load_state_dict(SENSIM.state_dict_from_flax(params, cfg),
                          strict=True)
    return model


def _assert_close(sd, tree, cfg, atol=1e-6, rtol=1e-4):
    want = SENSIM.state_dict_from_flax(jax.device_get(tree), cfg)
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


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = tiny_config(**WIDTH), jax_tiny_config(**WIDTH)
    params = SENSIM.random_params(cfg, 0)
    return dict(cfg=cfg, jcfg=jcfg, params=params, jm=JaxSenSim(jcfg),
                jparams=jax.tree.map(jnp.asarray, params))


CASES = {"pools": dict(pools=True, padded=False),
         "pools_padded": dict(pools=True, padded=True),
         "in_batch": dict(pools=False, padded=False),
         "in_batch_padded": dict(pools=False, padded=True)}


@pytest.fixture(scope="module")
def flax_outputs(setup):
    """The flax side in one program: encode and similarity of batch 0, and
    the loss and its gradient in every case."""
    jm = setup["jm"]
    b0 = _batch(0)

    @jax.jit
    def run(params):
        out = {"encode": jm.apply(params, b0["src"], b0["src_mask"],
                                  b0["src_langs"], method=JaxSenSim.encode),
               "sim": jm.apply(params, *[b0[k] for k in _ARGS[:6]],
                               method=JaxSenSim.similarity)}
        for name, kw in CASES.items():
            args, kwargs = _call(_batch(1, **kw))
            out[name] = jax.value_and_grad(
                lambda p: jm.apply(p, *args, **kwargs))(params)
        return out

    return jax.device_get(run(setup["jparams"]))


def test_encode_and_similarity_match_flax(setup, flax_outputs):
    model = _port(setup["cfg"], setup["params"])
    b = _torch(_batch(0))
    with torch.no_grad():
        enc = model.encode(b["src"], b["src_mask"], b["src_langs"])
        sim = model.similarity(*[b[k] for k in _ARGS[:6]])
    assert enc.dtype == torch.float32 and enc.shape == (B, WIDTH[
        "hidden_size"])
    np.testing.assert_allclose(enc.numpy(), flax_outputs["encode"],
                               atol=1e-4)
    np.testing.assert_allclose(sim.numpy(), flax_outputs["sim"], atol=1e-4)
    # Unit vectors but for the +1e-4 on the norm.
    norms = torch.linalg.vector_norm(enc, dim=-1)
    assert ((norms < 1.0) & (norms > 1.0 - 1e-3)).all()


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradient_match_jax(setup, flax_outputs, case):
    cfg = setup["cfg"]
    model = _port(cfg, setup["params"])
    args, kwargs = _call(_torch(_batch(1, **CASES[case])))
    loss = model(*args, **kwargs)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    want_loss, want_grads = flax_outputs[case]
    assert np.isfinite(float(loss.detach()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=1e-6,
                               rtol=1e-4)
    want = SENSIM.state_dict_from_flax(want_grads, cfg)
    for name, g in zip(names, grads):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-6,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("pools", [True, False])
def test_three_step_sgd_trajectory_matches_jax(setup, pools):
    cfg = setup["cfg"]
    model = _port(cfg, setup["params"])
    optim = _SGD(SGD_LR)
    state = pstep.create_train_state(dict(model.named_parameters()), optim)
    step = pstep.make_sensim_train_step(model, optim)
    jsgd = optax.sgd(SGD_LR)
    jstate = jstep.create_train_state(setup["jparams"], jsgd)
    jfn = jstep.make_sensim_train_step(setup["jm"], jsgd, donate=False)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        b = _batch(10 + i, pools=pools)
        jstate, jm_ = jfn(jstate, b, jax.random.PRNGKey(i))
        state, m = step(state, _torch(b), gen)
        assert float(m["ntokens"]) == float(jm_["ntokens"]) == B - 2
        np.testing.assert_allclose(float(m["sum_loss"]),
                                   float(jm_["sum_loss"]), rtol=1e-5)
        _assert_close(model.state_dict(), jstate.params, cfg)
    assert state.step == 3


# ---------------- the trainers ----------------

def _dev_batcher(seed=3, n=20):
    rng = np.random.RandomState(seed)
    examples = []
    for _ in range(n):
        src = [5] + list(rng.randint(7, V, rng.randint(2, 9))) + [4]
        dst = [6] + list(rng.randint(7, V, rng.randint(2, 9))) + [4]
        examples.append((src, dst, 0, 1))
    # 512 tokens a batch: 8 rows of 32 + 32 bucketed tokens.
    return MTBatcher(examples, pad_id=0, max_batch=512, capacity_mb=600)


@pytest.fixture(scope="module")
def jax_trainer(setup):
    tr = JaxSenSimTrainer(setup["jcfg"], None, lr=OPT["lr"],
                          warmup=OPT["warmup_updates"])
    tr.state = jstep.create_train_state(setup["jparams"], tr.optimizer)
    return tr


def _port_trainer(setup, params=None):
    return SenSimTrainer(setup["cfg"], None, params=params, lr=OPT["lr"],
                         warmup=OPT["warmup_updates"], device="cpu")


def test_trainer_eval_and_similarities_match_jax(setup, jax_trainer,
                                                 tmp_path):
    dev = _dev_batcher()
    assert [int(b.row_mask.sum()) for b in dev] == [8, 8, 4]  # a padded tail
    tr = _port_trainer(setup, setup["params"])
    jax_trainer.best_loss = float("inf")
    want = jax_trainer.eval(dev, str(tmp_path / "jax"))
    got = tr.eval(dev, str(tmp_path / "port"))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tr.best_loss == got and (tmp_path / "port" / "meta.json").exists()
    for b in dev:
        np.testing.assert_allclose(tr.similarities(b),
                                   jax_trainer.similarities(b), atol=1e-5)
    # A worse dev loss does not save; an equal one does (<=).
    tr.best_loss = got - 1.0
    tr.eval(dev, str(tmp_path / "port2"))
    assert not (tmp_path / "port2").exists()


def test_checkpoint_crosses_both_ways(setup, jax_trainer, tmp_path):
    """Two Adam steps in the port, saved; the JAX package loads params and
    the optimizer state into its templates (equal leaves); then what JAX
    saves loads back into a fresh port trainer (equal weights, moments and
    counts)."""
    cfg = setup["cfg"]
    tr = _port_trainer(setup, setup["params"])
    for i in range(2):
        tr.state, _ = tr.step_fn(tr.state, _torch(_batch(20 + i)), tr.rng)
    tr.best_loss = 1.5
    tr._save(str(tmp_path / "port"), 2)
    jstate = jax_trainer.state
    params, opt_state, meta = jckpt.load_checkpoint(
        str(tmp_path / "port"), jax.tree.map(jnp.zeros_like, jstate.params),
        jax.tree.map(jnp.zeros_like, jstate.opt_state))
    assert meta == {"step": 2, "best_metric": 1.5}
    _assert_close(tr.model.state_dict(), params, cfg, atol=0, rtol=0)
    jckpt.save_checkpoint(str(tmp_path / "jax"), setup["jcfg"], params,
                          opt_state=opt_state, step=2)
    tree, opt_tree, meta = ckpt.load_checkpoint(str(tmp_path / "jax"),
                                                with_opt_state=True)
    back = _port_trainer(setup)
    back.set_reference_params(tree, meta["step"])
    back.state.opt_state = opt_state_from_flax(opt_tree, back.optimizer, cfg,
                                               bridge=SENSIM)
    for name, p in tr.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[name], p), name
    a, c = tr.state.opt_state, back.state.opt_state
    assert (a.count, a.schedule_count) == (c.count, c.schedule_count) == (2, 2)
    for name in a.mu:
        assert torch.equal(a.mu[name], c.mu[name]), name
        assert torch.equal(a.nu[name], c.nu[name]), name
    # Both trainers take the same next step.
    nxt = _torch(_batch(30))
    tr.state, m1 = tr.step_fn(tr.state, nxt, tr.rng)
    back.state, m2 = back.step_fn(back.state, nxt, back.rng)
    assert torch.equal(m1["sum_loss"], m2["sum_loss"])


# ---------------- the CLIs ----------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A tokenizer (<en>, <fa>), a parallel .mt file, a dev .mt file and
    monolingual MASS shards of both languages."""
    from imagetranslate_tpu_torch.data.binarize import write_mt

    d = tmp_path_factory.mktemp("sensim")
    rng = np.random.RandomState(0)

    def sentence(n):
        return " ".join(WORDS[j] for j in rng.randint(0, len(WORDS), n))

    (d / "c.txt").write_text("\n".join(sentence(rng.randint(2, 7))
                                       for _ in range(150)))
    TextProcessor().train_tokenizer([str(d / "c.txt")], 200, str(d / "tok"),
                                    {"<en>": 0, "<fa>": 1})
    tp = TextProcessor(str(d / "tok"))
    for name, n in (("train", 24), ("dev", 10)):
        for lang in ("en", "fa"):
            (d / f"{name}.{lang}").write_text("\n".join(
                sentence(rng.randint(2, 8)) for _ in range(n)))
        write_mt(tp, str(d / f"{name}.mt"), str(d / f"{name}.en"),
                 tp.token_id("<en>"), str(d / f"{name}.fa"),
                 tp.token_id("<fa>"))
    for lang in ("en", "fa"):
        (d / f"mono.{lang}").write_text("\n".join(
            sentence(rng.randint(3, 8)) for _ in range(12)))
        write_mt(tp, str(d / f"mono_{lang}"), str(d / f"mono.{lang}"),
                 tp.token_id(f"<{lang}>"))
    return d


def _train_args(d, model, *extra):
    return ["--tok", str(d / "tok"), "--model", str(model), "--train_mt",
            str(d / "train.mt"), "--src-neg", str(d / "mono_en"),
            "--dst-neg", str(d / "mono_fa"), "--embed", "48",
            "--intermediate", "96", "--enc", "1", "--warmup", "2",
            "--batch", "4000", "--dtype", "float32", "--device", "cpu",
            *extra]


def setup_cfg(model):
    return ckpt.load_config(str(model))


def _read_tsv(path):
    rows = [line.split("\t") for line in path.read_text().splitlines()]
    return [r[:2] for r in rows], np.array([float(r[2]) for r in rows])


def test_cli_train_sensim_then_get_sen_sim(corpus, tmp_path):
    """Two steps with the negative pools and a dev set, the best slot and
    ``.latest`` written; ``get_sen_sim`` of both packages on the port's
    checkpoint writes the same pairs and scores; ``--pretrained`` starts a
    run from it."""
    from imagetranslate_tpu.cli import get_sen_sim as jax_get_sen_sim
    from imagetranslate_tpu_torch.cli import get_sen_sim, train_sensim

    model = tmp_path / "m"
    train_sensim.main(_train_args(corpus, model, "--step", "2", "--dev_mt",
                                  str(corpus / "dev.mt")))
    assert ckpt.load_checkpoint(str(model) + ".latest")[2]["step"] == 2
    assert ckpt.load_checkpoint(str(model))[2]["step"] in (1, 2)  # best
    args = ["--tok", str(corpus / "tok"), "--model", str(model), "--dev_mt",
            str(corpus / "dev.mt")]
    get_sen_sim.main(args + ["--output", str(tmp_path / "port.tsv"),
                             "--device", "cpu"])
    jax_get_sen_sim.main(args + ["--output", str(tmp_path / "jax.tsv")])
    pairs, sims = _read_tsv(tmp_path / "port.tsv")
    jpairs, jsims = _read_tsv(tmp_path / "jax.tsv")
    assert pairs == jpairs and len(pairs) == 10
    assert all(a and b for a, b in pairs)
    np.testing.assert_allclose(sims, jsims, atol=1e-5)
    assert (np.abs(sims) <= 1.0).all()

    # --pretrained: the run starts from the checkpoint's weights (one Adam
    # step of at most lr away; a fresh start is 2e-2 away).
    again = tmp_path / "again"
    train_sensim.main(_train_args(corpus, again, "--step", "1",
                                  "--pretrained", str(model)))
    start, after = (SENSIM.state_dict_from_flax(ckpt.load_params(p), cfg)
                    for cfg, p in [(setup_cfg(model), str(model)),
                                   (setup_cfg(model), str(again) + ".latest")])
    for name, leaf in start.items():
        assert (after[name] - leaf).abs().max() <= 1e-4, name


def test_cli_train_sensim_refusals(corpus, tmp_path):
    from imagetranslate_tpu_torch.cli import train_sensim

    with pytest.raises(SystemExit, match="module 14"):
        train_sensim.main(_train_args(corpus, tmp_path / "m", "--step", "1",
                                      "--mesh", "2x1"))
    with pytest.raises(SystemExit, match="multiple of"):
        train_sensim.main(_train_args(corpus, tmp_path / "m", "--step", "1",
                                      "--embed", "50"))
    assert not (tmp_path / "m").exists()
