"""The port's unsupervised-MT path (MASS pretraining, then back-translation)
against the JAX package, on the CPU at a tiny size, fp32, dropout 0.

- a MASS-step loss trajectory of both packages from the same flax-initialised
  weights on the same batches, with the JAX package's span draws fed to the
  port's step (per-step loss rtol 1e-4; parameters at the end atol 2e-4, as
  in the MT trajectory test);
- host side: monolingual ``write_mt`` shards byte for byte, ``load_mass`` and
  ``MassBatcher`` (``shuffled`` included) array for array;
- one back-translation step of both trainers from the same weights: the same
  generated tokens, then the same loss (rtol 1e-4);
- supervised epochs, then a back-translation epoch, through the port's
  ``MTTrainer.train_epoch`` (the flow of tests/test_trainer_e2e.py);
- ``cli.train_mt --mass_train --fstep --langs`` end to end, its checkpoint
  translated identically by the JAX translate CLI, and the same command line
  with jax, flax, optax and the JAX package impossible to import.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.data import binarize as jbinarize
from imagetranslate_tpu.data.loader import MassBatcher as JaxMassBatcher
from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.models.seq2seq import Seq2Seq as JaxSeq2Seq
from imagetranslate_tpu.text.processor import TextProcessor as JaxTextProcessor
from imagetranslate_tpu.train import optimizer as jopt
from imagetranslate_tpu.train import step as jstep
from imagetranslate_tpu.train.trainer_mt import MTTrainer as JaxMTTrainer
from imagetranslate_tpu_torch.data import binarize
from imagetranslate_tpu_torch.data.loader import (
    MassBatch,
    MassBatcher,
    MTBatcher,
)
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
from imagetranslate_tpu_torch.ops.masking import MassDraws
from imagetranslate_tpu_torch.text.processor import TextProcessor
from imagetranslate_tpu_torch.train import checkpoint as ckpt
from imagetranslate_tpu_torch.train import optimizer as opt
from imagetranslate_tpu_torch.train import step as pstep
from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer
from imagetranslate_tpu_torch.train.weights import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["alpha", "beta", "gamma", "delta", "epsi", "zeta", "eta", "theta"]
V, B, S, NSPEC, MASK_ID = 48, 8, 12, 7, 3
OPT = dict(lr=1e-3, warmup_updates=4, clip_norm=1.0)
CPU = torch.device("cpu")
QUIET = dict(eval_every=10 ** 9, save_every=10 ** 9, log_every=10 ** 9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """At these sizes one intra-op thread is the fastest, and the file's time
    stays steady when other test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------- the MASS step ----------------

def _mass_batch(seed, lang=0):
    rng = np.random.RandomState(seed)
    # ids drawn with a skew, so that there is a unigram distribution to learn
    src = (NSPEC + (V - NSPEC) * rng.rand(B, S) ** 3).astype(np.int32)
    lengths = rng.randint(4, S + 1, B).astype(np.int32)
    src = np.where(np.arange(S)[None, :] < lengths[:, None], src, 0).astype(
        np.int32)
    row_mask = np.ones(B, bool)
    row_mask[-1] = False                               # a padding row
    return MassBatch(src, src != 0, np.full(B, lang, np.int32),
                     src[:, 0].copy(), lengths, row_mask)


def _jax_mass_draws(rng, src, lengths, mask_prob, n_specials, vocab):
    """The draws ``jax mass_mask(rng, ...)`` makes
    (imagetranslate_tpu/ops/masking.py), as torch tensors."""
    r_kind, r_start, r_corrupt = jax.random.split(rng, 3)
    lengths = jnp.asarray(lengths).astype(jnp.int32)
    last_idx = jnp.maximum(jnp.ceil(lengths.astype(jnp.float32)
                                    * mask_prob).astype(jnp.int32), 2)
    kind = jax.random.uniform(r_kind, (src.shape[0],))
    rand_start = jax.random.randint(r_start, (src.shape[0],), 2, last_idx + 1)
    r_choice, r_rand = jax.random.split(r_corrupt)
    u = jax.random.uniform(r_choice, src.shape)
    rand_tok = jax.random.randint(r_rand, src.shape, n_specials, vocab)
    return MassDraws(*(torch.tensor(np.asarray(a))
                       for a in (kind, rand_start, u, rand_tok)))


@pytest.mark.parametrize("variant", ["base", "lang_dec"])
def test_mass_loss_trajectory_and_final_parameters(variant):
    """With ``lang_dec`` a one-language MASS batch reaches one decoder: the
    other's gradient is zero in both packages."""
    kw = {"lang_dec": True} if variant == "lang_dec" else {}
    jcfg, cfg = jax_tiny_config(vocab_size=V, **kw), tiny_config(V, **kw)
    jmodel = JaxSeq2Seq(jcfg)
    ids = jnp.zeros((2, 8), jnp.int32)
    ones = jnp.ones((2, 8), bool)
    langs = jnp.zeros((2,), jnp.int32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(1), ids, ones, ids,
                                        ones, langs, langs))
    joptim = jopt.build_optimizer(**OPT)
    jstate = jstep.create_train_state(params, joptim)
    jmass = jstep.make_mass_train_step(
        jmodel, joptim, jcfg, mask_prob=0.5, n_specials=NSPEC,
        mask_id=MASK_ID, donate=False)

    model = Seq2Seq(cfg, param_dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(params, cfg))
    optim = opt.build_optimizer(**OPT)
    state = pstep.create_train_state(dict(model.named_parameters()), optim)
    mass = pstep.make_mass_train_step(model, optim, cfg, mask_prob=0.5,
                                      n_specials=NSPEC, mask_id=MASK_ID)
    gen = torch.Generator().manual_seed(0)

    jl, pl = [], []
    for i in range(6):
        b = _mass_batch(10 + i % 3, lang=1 if variant == "lang_dec" else 0)
        rng = jax.random.PRNGKey(100 + i)
        jstate, m = jmass(jstate, jstep.mass_batch_to_device(b), rng)
        jl.append(float(m["sum_loss"]) / float(m["ntokens"]))
        r_mask, _ = jax.random.split(rng)
        draws = _jax_mass_draws(r_mask, b.src, b.lengths, 0.5, NSPEC, V)
        state, m = mass(state, pstep.mass_batch_to_device(b, CPU), gen,
                        draws=draws)
        pl.append(m["sum_loss"].item() / m["ntokens"].item())
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert pl[-1] < pl[0] - 0.01                      # it learns
    assert state.step == int(jstate.step) == 6
    want = state_dict_from_flax(jax.device_get(jstate.params), cfg)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, leaf in want.items():
        if ".self.key.bias" in name:       # its gradient is rounding noise
            continue
        np.testing.assert_allclose(got[name].numpy(), leaf.numpy(),
                                   atol=2e-4, err_msg=name)
    if variant == "lang_dec":                          # decoder 0 never moved
        name = "decoder.0.decoder.layer.0.output.dense.weight"
        np.testing.assert_array_equal(
            got[name].numpy(),
            state_dict_from_flax(params, cfg)[name].numpy())


def test_mass_step_draws_on_its_own_and_follows_the_seed():
    """Without fed draws the step draws from a device generator seeded from
    the host generator: same seed, same loss; another seed, another span."""
    from imagetranslate_tpu_torch.train.weights import random_params

    cfg = tiny_config(V, initializer_range=0.3)
    losses = []
    for seed in (0, 0, 1):
        model = Seq2Seq(cfg, param_dtype=torch.float32)
        model.load_state_dict(state_dict_from_flax(random_params(cfg, 0),
                                                   cfg))
        optim = opt.build_optimizer(**OPT)
        state = pstep.create_train_state(dict(model.named_parameters()),
                                         optim)
        step = pstep.make_mass_train_step(model, optim, cfg, n_specials=NSPEC,
                                          mask_id=MASK_ID)
        _, m = step(state, pstep.mass_batch_to_device(_mass_batch(0), CPU),
                    torch.Generator().manual_seed(seed))
        assert 0 < m["ntokens"].item() <= (B - 1) * (S // 2)
        losses.append(m["sum_loss"].item())
    assert losses[0] == losses[1] != losses[2]


# ---------------- host side ----------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two monolingual corpora (a copy task: <bb> text is <aa> text), a
    two-language tokenizer, and the port's monolingual shards."""
    d = tmp_path_factory.mktemp("umt")
    rng = np.random.RandomState(0)

    def lines(n):
        return [" ".join(WORDS[j] for j in rng.randint(0, len(WORDS),
                                                       rng.randint(2, 7)))
                for _ in range(n)]

    aa, bb, dev = lines(90), lines(90), lines(10)
    aa[7] = ""                                        # skipped by write_mt
    for name, rows in (("aa", aa), ("bb", bb), ("dev", dev)):
        (d / f"{name}.txt").write_text("\n".join(rows) + "\n")
    TextProcessor().train_tokenizer([str(d / "aa.txt")], 120, str(d / "tok"),
                                    {"<aa>": 0, "<bb>": 1})
    tp = TextProcessor(str(d / "tok"))
    for lang in ("aa", "bb"):
        n = binarize.write_mt(tp, str(d / f"mono.{lang}"),
                              str(d / f"{lang}.txt"),
                              tp.token_id(f"<{lang}>"), shard_size=40)
        assert n == (89 if lang == "aa" else 90)
    return d, tp


def test_monolingual_shards_and_mass_batches_match_jax(corpus, tmp_path):
    d, tp = corpus
    jtp = JaxTextProcessor(str(d / "tok"))
    assert tp.mask_token_id() == jtp.mask_token_id() == MASK_ID
    assert len(tp.special_tokens) == len(jtp.special_tokens) == NSPEC
    n = jbinarize.write_mt(jtp, str(tmp_path / "jax.aa"), str(d / "aa.txt"),
                           jtp.token_id("<aa>"), shard_size=40)
    assert n == 89
    shards = sorted(p.name for p in d.glob("mono.aa.*"))
    assert shards == ["mono.aa.0", "mono.aa.1", "mono.aa.2"]
    for i in range(3):
        assert (tmp_path / f"jax.aa.{i}").read_bytes() == \
            (d / f"mono.aa.{i}").read_bytes()
    examples = binarize.load_mass(str(d / "mono."))
    assert examples == jbinarize.load_mass(str(d / "mono."))
    assert len(examples) == 179 and {e[1] for e in examples} == {0, 1}
    assert examples[0][0][0] == tp.token_id("<aa>")
    assert examples[0][0][-1] == tp.sep_token_id()
    packed = tmp_path / "packed.0"
    packed.write_bytes(b"ITR1" + b"\0" * 16)
    with pytest.raises(NotImplementedError, match="module 15"):
        binarize.load_mass(str(tmp_path / "packed"))

    examples.sort(key=lambda e: len(e[0]))
    for kw in (dict(max_batch=200, capacity_mb=600),
               dict(max_batch=4000, capacity_mb=1, max_seq_len=7)):
        batcher = MassBatcher(examples, pad_id=0, **kw)
        want = JaxMassBatcher(examples, pad_id=0, **kw)
        assert len(batcher) == len(want) > 1
        for got, ref in ((list(batcher), list(want)),
                         (list(batcher.shuffled(5)), list(want.shuffled(5)))):
            for g, w in zip(got, ref):
                for name in ("src", "src_mask", "langs", "lang_tokens",
                             "lengths", "row_mask"):
                    np.testing.assert_array_equal(getattr(g, name),
                                                  getattr(w, name))
                    assert getattr(g, name).dtype == getattr(w, name).dtype
    staged = pstep.mass_batch_to_device(batcher.batches[0], CPU)
    want = jstep.mass_batch_to_device(batcher.batches[0])
    assert set(staged) == set(want)


# ---------------- back-translation ----------------

def _mono(tp, n=16, seed=1):
    rng = np.random.RandomState(seed)
    sens = [" ".join(WORDS[j] for j in rng.randint(0, len(WORDS),
                                                   rng.randint(2, 5)))
            for _ in range(n)]
    mono = [(tp.tokenize_one_sentence_with_langid(
        s, tp.token_id("<aa>" if i % 2 else "<bb>")), i % 2 == 0)
        for i, s in enumerate(sens)]
    mono = [(ids, int(is_bb)) for ids, is_bb in mono]
    mono.sort(key=lambda e: len(e[0]))
    return mono


def test_bt_step_matches_jax(corpus):
    """One back-translation step of both trainers from the same weights: the
    greedy decodes agree token for token and the MT step on the synthetic
    pairs gives the same loss."""
    d, tp = corpus
    jtp = JaxTextProcessor(str(d / "tok"))
    kw = dict(vocab_size=tp.vocab_size(), num_languages=2,
              initializer_range=0.3)
    jcfg, cfg = jax_tiny_config(**kw), tiny_config(**kw)
    tkw = dict(lr=3e-3, warmup=20, bt_beam_width=1, max_len_a=1.1,
               max_len_b=3)
    jtrainer = JaxMTTrainer(jcfg, jtp, **tkw)
    params = jax.device_get(jtrainer.state.params)
    trainer = MTTrainer(cfg, tp, params=params, device="cpu", **tkw)
    mass = MassBatcher(_mono(tp), pad_id=0, max_batch=200)
    dirs = MTTrainer.lang_directions(["aa", "bb"], tp)
    assert dirs == JaxMTTrainer.lang_directions(["aa", "bb"], jtp)

    decoded = {}

    def capture(tr, name):
        inner = tr._decode_batch

        def wrapped(*a, **k):
            best, lengths = inner(*a, **k)
            decoded[name] = (np.asarray(best), np.asarray(lengths))
            return best, lengths
        tr._decode_batch = wrapped

    capture(jtrainer, "jax")
    capture(trainer, "port")
    b = mass.batches[0]
    assert {0, 1} == set(b.langs.tolist())             # both directions
    jm = jtrainer._bt_step(b, dirs, jax.random.PRNGKey(0))
    pm = trainer._bt_step(b, dirs, trainer.rng)
    np.testing.assert_array_equal(decoded["port"][0], decoded["jax"][0])
    np.testing.assert_array_equal(decoded["port"][1], decoded["jax"][1])
    # every row starts with the OTHER language's token
    assert (decoded["port"][0][:, 0] == [dirs[t] for t in b.src[:, 0]]).all()
    assert float(jm["ntokens"]) == pm["ntokens"].item()
    np.testing.assert_allclose(
        pm["sum_loss"].item() / pm["ntokens"].item(),
        float(jm["sum_loss"]) / float(jm["ntokens"]), rtol=1e-4)
    assert trainer.state.step == int(jtrainer.state.step) == 1


def _parallel(tp, n, seed):
    rng = np.random.RandomState(seed)
    examples = []
    for _ in range(n):
        sen = " ".join(WORDS[j] for j in rng.randint(0, len(WORDS),
                                                     rng.randint(2, 5)))
        examples.append((
            tp.tokenize_one_sentence_with_langid(sen, tp.token_id("<aa>")),
            tp.tokenize_one_sentence_with_langid(sen, tp.token_id("<bb>")),
            0, 1))
    examples.sort(key=lambda e: len(e[1]))
    return examples


def test_supervised_then_bt(corpus, tmp_path, capsys):
    """Supervised epochs with a dev BLEU, then the back-translation phase
    over monolingual <aa>/<bb> rows, through ``train_epoch``."""
    d, tp = corpus
    cfg = tiny_config(vocab_size=tp.vocab_size(), num_languages=2)
    trainer = MTTrainer(cfg, tp, lr=3e-3, warmup=20, beam_width=2,
                        bt_beam_width=1, max_len_a=1.1, max_len_b=3,
                        device="cpu")
    examples = _parallel(tp, 60, 1)
    mt = MTBatcher(examples, pad_id=0, max_batch=400, capacity_mb=600)
    dev = MTBatcher(_parallel(tp, 10, 2), pad_id=0, max_batch=200,
                    capacity_mb=600)
    save = str(tmp_path / "model")
    step, epoch = 0, 0
    while step < 30:
        step = trainer.train_epoch(step, save, mt_batcher=mt,
                                   dev_batcher=dev if step >= 20 else None,
                                   max_step=30, eval_every=1000,
                                   save_every=1000, log_every=10,
                                   epoch_seed=epoch)
        epoch += 1
    assert step == 30
    assert os.path.exists(os.path.join(save + ".latest", "params.msgpack"))
    assert os.path.exists(os.path.join(save, "bleu.output"))
    assert trainer.best_bleu >= 0.0

    trainer.reset_for_finetune()
    assert trainer.state.opt_state.schedule_count == 0
    dirs = MTTrainer.lang_directions(["aa", "bb"], tp)
    mono = [(e[0], 0) for e in examples[:16]] + \
           [(e[1], 1) for e in examples[:16]]
    mono.sort(key=lambda e: len(e[0]))
    mass = MassBatcher(mono, pad_id=0, max_batch=200, capacity_mb=600)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    capsys.readouterr()
    step = trainer.train_epoch(step, save, mass_batcher=mass,
                               max_step=step + 6, fine_tune=True,
                               lang_directions=dirs, eval_every=10_000,
                               save_every=10_000, log_every=5)
    assert step == 36 == trainer.state.step
    assert "tokens/sec" in capsys.readouterr().out
    assert any(not torch.equal(before[k], v)
               for k, v in trainer.model.state_dict().items())
    assert ckpt.load_checkpoint(save + ".latest")[2]["step"] == 36


def test_interleaved_streams_take_one_batch_each_per_tick(corpus, tmp_path):
    """mass, mt, mass, mt, ...; the shortest stream ends the epoch."""
    d, tp = corpus
    trainer = MTTrainer(tiny_config(vocab_size=tp.vocab_size()), tp,
                        device="cpu")
    mt = MTBatcher(_parallel(tp, 40, 3), pad_id=0, max_batch=640)
    mass = MassBatcher(_mono(tp, 40), pad_id=0, max_batch=256)
    assert len(mass) > len(mt) > 1
    order = []
    steps = {"mt": trainer.mt_step, "mass": trainer.mass_step}
    for kind, fn in steps.items():
        def spy(state, batch, rng, kind=kind, fn=fn):
            order.append(kind)
            return fn(state, batch, rng)
        setattr(trainer, f"{kind}_step", spy)
    step = trainer.train_epoch(0, str(tmp_path / "m"), mt_batcher=mt,
                               mass_batcher=mass, **QUIET)
    assert step == 2 * len(mt)
    assert order == ["mass", "mt"] * len(mt)


# ---------------- the CLI ----------------

def _umt_args(d, model, *extra):
    return ["--tok", str(d / "tok"), "--model", str(model), "--mass_train",
            str(d / "mono."), "--embed", "48", "--intermediate", "64",
            "--enc", "2", "--dec", "2", "--batch", "600", "--lr", "0.005",
            "--warmup", "20", "--dtype", "float32", "--dropout", "0.1",
            "--step", "6", "--fstep", "3", "--langs", "aa,bb", "--device",
            "cpu", *extra]


def test_cli_mass_then_bt_and_jax_translates_the_checkpoint(corpus, tmp_path,
                                                            capsys):
    from imagetranslate_tpu.cli.translate import main as jax_translate
    from imagetranslate_tpu_torch.cli.train_mt import main
    from imagetranslate_tpu_torch.cli.translate import main as translate

    d, tp = corpus
    model = tmp_path / "model"
    main(_umt_args(d, model, "--bt-beam", "2", "--mask", "0.4"))
    out = capsys.readouterr().out
    assert "MASS train batches:" in out and "train epoch 0" in out
    assert "finetune epoch 0" in out and "Finished Training!" in out
    aa, bb = tp.token_id("<aa>"), tp.token_id("<bb>")
    assert f"lang dirs {{{aa}: {bb}, {bb}: {aa}}}" in out
    latest = str(model) + ".latest"
    _, opt_tree, meta = ckpt.load_checkpoint(latest, with_opt_state=True)
    assert meta["step"] == 9
    # Adam counted every step; the schedule restarted for the fine-tune phase
    assert int(opt_tree["1"]["count"]) == 9
    assert int(opt_tree["2"]["count"]) == 3
    args = ["--tok", str(d / "tok"), "--model", latest, "--input",
            str(d / "dev.txt"), "--src", "aa", "--target", "bb", "--beam",
            "2"]
    translate(args + ["--output", str(tmp_path / "port.out"), "--device",
                      "cpu"])
    jax_translate(args + ["--output", str(tmp_path / "jax.out")])
    got = (tmp_path / "port.out").read_text()
    assert got == (tmp_path / "jax.out").read_text()
    assert len(got.splitlines()) == 10


def test_cli_fused_loss_through_pretrained_config(corpus, tmp_path):
    """``use_pallas_xent`` reaches the CLI through a checkpoint's
    config.json: the MASS and back-translation steps run the fused loss."""
    import dataclasses

    from imagetranslate_tpu_torch.cli.train_mt import main
    from imagetranslate_tpu_torch.ops import xent
    from imagetranslate_tpu_torch.train.weights import random_params

    d, tp = corpus
    cfg = dataclasses.replace(
        tiny_config(vocab_size=tp.vocab_size(), num_languages=2),
        use_pallas_xent=True)
    ckpt.save_params(str(tmp_path / "init"), cfg, random_params(cfg, 0))
    calls = []
    plain = xent.smoothed_xent_rows_reference

    def counting(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    xent.smoothed_xent_rows_reference = counting
    try:
        main(_umt_args(d, tmp_path / "model", "--pretrained",
                       str(tmp_path / "init")))
    finally:
        xent.smoothed_xent_rows_reference = plain
    assert len(calls) == 9
    assert ckpt.load_config(str(tmp_path / "model") + ".latest"
                            ).use_pallas_xent


_NO_JAX = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "imagetranslate_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    import imagetranslate_tpu_torch.ops.xent
    import imagetranslate_tpu_torch.ops.masking
    import imagetranslate_tpu_torch.data.loader
    import imagetranslate_tpu_torch.data.binarize
    import imagetranslate_tpu_torch.train.step
    import imagetranslate_tpu_torch.train.trainer_mt
    from imagetranslate_tpu_torch.cli.train_mt import main
    main(sys.argv[1:])
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
""")


def test_umt_cli_runs_without_jax(corpus, tmp_path):
    """MASS then back-translation through the CLI with jax, jaxlib, flax,
    optax and the JAX package unimportable."""
    d, _ = corpus
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO
           + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = tmp_path / "nojax"
    subprocess.run([sys.executable, "-c", _NO_JAX, *_umt_args(d, out)],
                   check=True, cwd=REPO, env=env, timeout=300)
    assert ckpt.load_checkpoint(str(out) + ".latest")[2]["step"] == 9
