"""The port's MT trainer, its host side and its training CLI, on the CPU at a
tiny size.

- host side against the JAX package: ``data.binarize.write_mt`` / ``load_mt``
  write and read the same ``.mt`` artifact, ``MTBatcher.shuffled`` yields the
  same batches in the same order for the same seed, the step meters print
  the same lines;
- ``MTTrainer.train_epoch`` on a toy copy corpus (the real loop: prefetch
  thread, deferred metrics, ``.latest`` checkpoints): the loss falls, and
  ``eval_bleu`` decodes the dev set, writes its transcripts and the best slot;
- ``cli.train_mt`` -> ``cli.translate`` through files, the checkpoint the
  port trained translated identically by the JAX CLI, and ``--pretrained
  --cont`` resuming with the optimizer state;
- flags whose path is not ported stop the run with the ROADMAP module named,
  and the flags of the MASS and back-translation phases are accepted;
- the training CLI runs with jax, flax, optax and the JAX package impossible
  to import.
"""

import io
import os
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from imagetranslate_tpu.data import binarize as jbinarize
from imagetranslate_tpu.data.loader import MTBatcher as JaxMTBatcher
from imagetranslate_tpu.text.processor import TextProcessor as JaxTextProcessor
from imagetranslate_tpu.utils import metrics as jmetrics
from imagetranslate_tpu_torch.data import binarize
from imagetranslate_tpu_torch.data.loader import MassBatcher, MTBatcher
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.text.processor import TextProcessor
from imagetranslate_tpu_torch.train import checkpoint as ckpt
from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer
from imagetranslate_tpu_torch.train.weights import opt_state_from_flax
from imagetranslate_tpu_torch.utils import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["alpha", "beta", "gamma", "delta", "epsi", "zeta", "eta", "theta"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """At these sizes one intra-op thread is the fastest, and the file's time
    stays steady when other test workers load every core (torch's thread pool
    spins against them otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A copy task: the target is the source. Tokenizer, train/dev text and
    the binarized files, written by the port."""
    d = tmp_path_factory.mktemp("trainer")
    rng = np.random.RandomState(0)

    def lines(n):
        return [" ".join(WORDS[j] for j in rng.randint(0, len(WORDS),
                                                       rng.randint(2, 7)))
                for _ in range(n)]

    train, dev = lines(160), lines(12)
    train[5] = ""                                     # skipped by write_mt
    for name, rows in (("train", train), ("dev", dev)):
        (d / f"{name}.src").write_text("\n".join(rows) + "\n")
        (d / f"{name}.dst").write_text("\n".join(rows) + "\n")
    TextProcessor().train_tokenizer([str(d / "train.src")], 120,
                                    str(d / "tok"), {"<aa>": 0, "<bb>": 1})
    tp = TextProcessor(str(d / "tok"))
    for name in ("train", "dev"):
        n = binarize.write_mt(tp, str(d / f"{name}.mt"),
                              str(d / f"{name}.src"), tp.token_id("<aa>"),
                              str(d / f"{name}.dst"), tp.token_id("<bb>"))
        assert n == (159 if name == "train" else 12)
    return d, tp


def test_binarize_matches_jax(corpus, tmp_path):
    d, tp = corpus
    jtp = JaxTextProcessor(str(d / "tok"))
    out = tmp_path / "jax.mt"
    n = jbinarize.write_mt(jtp, str(out), str(d / "train.src"),
                           jtp.token_id("<aa>"), str(d / "train.dst"),
                           jtp.token_id("<bb>"))
    assert n == 159
    assert out.read_bytes() == (d / "train.mt").read_bytes()
    assert binarize.load_mt(str(out)) == jbinarize.load_mt(str(d / "train.mt"))
    ex = binarize.load_mt(str(out))[0]
    assert ex[0][0] == tp.token_id("<aa>") and ex[1][0] == tp.token_id("<bb>")
    assert ex[0][-1] == tp.sep_token_id() and (ex[2], ex[3]) == (0, 1)
    with pytest.raises(NotImplementedError, match="module 15"):
        binarize.write_mt(tp, str(tmp_path / "p"), str(d / "train.src"),
                          tp.token_id("<aa>"), str(d / "train.dst"),
                          tp.token_id("<bb>"), packed=True)
    packed = tmp_path / "packed.mt"
    packed.write_bytes(b"ITR1" + b"\0" * 16)
    with pytest.raises(NotImplementedError, match="module 15"):
        binarize.load_mt(str(packed))


@pytest.mark.parametrize("seed", [0, 7])
def test_shuffled_batches_match_jax(corpus, seed):
    d, _ = corpus
    examples = binarize.load_mt(str(d / "train.mt"))
    kw = dict(pad_id=0, max_batch=400, capacity_mb=300)
    batcher = MTBatcher(examples, **kw)
    got = list(batcher.shuffled(seed))
    want = list(JaxMTBatcher(examples, **kw).shuffled(seed))
    assert len(got) == len(want) > 3
    assert any(g is not b for g, b in zip(got, batcher))   # really shuffled
    for g, w in zip(got, want):
        for name in ("src", "src_mask", "dst", "dst_mask", "src_langs",
                     "dst_langs", "src_sizes", "row_mask"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))


@pytest.mark.parametrize("cls", ["StepMeter", "AsyncStepMeter"])
def test_step_meters_print_what_jax_prints(cls):
    def run(mod, scalar):
        buf, jsonl = io.StringIO(), io.StringIO()
        with redirect_stdout(buf):
            m = getattr(mod, cls)(log_every=2, jsonl=jsonl, prefix="p ")
            for step in range(1, 6):
                m.update(step, scalar(3.0 * step), scalar(10.0))
            m.finish(5)
        lines = [" ".join(ln.split()[:5]) for ln in
                 buf.getvalue().splitlines()]
        return lines, m.epoch_loss(), len(jsonl.getvalue().splitlines())

    want = run(jmetrics, float)
    got = run(metrics, torch.tensor if cls == "AsyncStepMeter" else float)
    assert got[0] == want[0] and len(got[0]) == 2
    assert got[1] == pytest.approx(want[1]) and got[2] == want[2] == 2


def _trainer(tp, **kw):
    cfg = tiny_config(vocab_size=tp.vocab_size(), num_languages=2,
                      initializer_range=0.1)
    return MTTrainer(cfg, tp, lr=5e-3, warmup=20, device="cpu", **kw)


def test_train_epoch_learns_and_eval_bleu_saves_best(corpus, tmp_path,
                                                     capsys):
    d, tp = corpus
    pad = tp.pad_token_id()
    train = MTBatcher(binarize.load_mt(str(d / "train.mt")), pad_id=pad,
                      max_batch=600)
    dev = MTBatcher(binarize.load_mt(str(d / "dev.mt")), pad_id=pad,
                    max_batch=200)
    trainer = _trainer(tp, beam_width=2)
    path = str(tmp_path / "model")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    step, losses = 0, []
    for epoch in range(12):
        step = trainer.train_epoch(step, path, mt_batcher=train,
                                   eval_every=10 ** 9, save_every=10 ** 9,
                                   log_every=10 ** 9, epoch_seed=epoch)
        out = capsys.readouterr().out
        losses.append(float(out.split("Total loss in this epoch:")[1]
                            .split()[0]))
    assert step == 12 * len(train) == trainer.state.step
    assert losses[-1] < 0.6 * losses[0], losses
    assert any(not torch.equal(before[k], v)
               for k, v in trainer.model.state_dict().items())
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())

    # the rolling slot holds weights, optimizer state and meta
    params, opt_tree, meta = ckpt.load_checkpoint(path + ".latest",
                                                  with_opt_state=True)
    assert meta["step"] == step and meta["best_metric"] == -1.0
    state = opt_state_from_flax(opt_tree, trainer.optimizer, trainer.cfg)
    assert state.count == state.schedule_count == step
    name = "decoder.decoder.layer.0.attention.self.query.weight"
    assert torch.equal(state.mu[name], trainer.state.opt_state.mu[name])

    bleu = trainer.eval_bleu(dev, path)
    assert 50.0 < bleu <= 100.0 + 1e-6 and trainer.best_bleu == bleu
    assert len(trainer.reference) == 12
    transcript = open(os.path.join(path, "bleu.output")).read()
    assert transcript.count("***************") == 12
    assert open(os.path.join(path, "bleu.best.output")).read() == transcript
    assert ckpt.load_checkpoint(path)[2]["best_metric"] == bleu
    # a second eval that is no better leaves the best slot alone
    stamp = os.path.getmtime(os.path.join(path, "params.msgpack"))
    assert trainer.eval_bleu(dev, path) == bleu
    assert os.path.getmtime(os.path.join(path, "params.msgpack")) == stamp

    # max_step cuts an epoch; the schedule restarts for fine-tuning
    assert trainer.train_epoch(step, path, mt_batcher=train,
                               max_step=step + 2, log_every=1) == step + 2
    assert "tokens/sec" in capsys.readouterr().out
    trainer.reset_for_finetune()
    assert trainer.state.opt_state.schedule_count == 0
    assert trainer.state.opt_state.count == step + 2
    trainer.set_reference_params(params, step=40)
    assert trainer.state.opt_state.schedule_count == 40
    assert trainer.state.opt_state.count == 0


def test_trainer_refuses_what_is_not_ported(corpus, tmp_path):
    d, tp = corpus
    cfg = tiny_config(vocab_size=tp.vocab_size())
    for kw in ({"mesh": object()}, {"pp_microbatches": 2}, {"zero": True}):
        with pytest.raises(NotImplementedError, match="module 14"):
            MTTrainer(cfg, tp, device="cpu", **kw)
    trainer = _trainer(tp)
    # The image stream trains an ImageSeq2Seq (ImageMTTrainer), not this
    # trainer's text model.
    with pytest.raises(ValueError, match="ImageMTTrainer"):
        trainer.train_epoch(0, str(tmp_path), img_batcher=[1])
    assert not hasattr(trainer, "_img_step")
    assert trainer.train_epoch(3, str(tmp_path)) == 3    # no stream
    assert trainer.train_epoch(3, str(tmp_path), fine_tune=True) == 3


def test_trainer_runs_the_mass_and_bt_streams(corpus, tmp_path):
    """What the trainer once refused (ROADMAP module 8): a MASS stream, the
    fine-tune phase and lang_directions run."""
    d, tp = corpus
    mono = [(ex[0], 0) for ex in binarize.load_mt(str(d / "dev.mt"))]
    mono += [(ex[1], 1) for ex in binarize.load_mt(str(d / "dev.mt"))]
    mono.sort(key=lambda e: len(e[0]))
    mass = MassBatcher(mono, pad_id=tp.pad_token_id(), max_batch=400)
    trainer = _trainer(tp)
    path = str(tmp_path / "m")
    kw = dict(eval_every=10 ** 9, save_every=10 ** 9, log_every=10 ** 9)
    assert trainer.train_epoch(0, path, mass_batcher=mass, **kw) == len(mass)
    dirs = MTTrainer.lang_directions(["aa", "bb"], tp)
    aa, bb = tp.token_id("<aa>"), tp.token_id("<bb>")
    assert dirs == {aa: bb, bb: aa}
    with pytest.raises(ValueError, match="exactly two"):
        MTTrainer.lang_directions(["aa"], tp)
    with pytest.raises(ValueError, match="lang_directions"):
        trainer.train_epoch(0, path, mass_batcher=mass, fine_tune=True)
    m = trainer._bt_step(mass.batches[0], dirs, trainer.rng)
    assert torch.isfinite(m["sum_loss"]) and m["ntokens"].item() > 0
    assert trainer.state.step == len(mass) + 1


def _train_args(d, model, *extra):
    return ["--tok", str(d / "tok"), "--model", str(model), "--train_mt",
            str(d / "train.mt"), "--embed", "48", "--intermediate", "64",
            "--enc", "2", "--dec", "2", "--batch", "1200", "--lr", "0.005",
            "--warmup", "20", "--dtype", "float32", "--dropout", "0.1",
            "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    from imagetranslate_tpu_torch.cli.train_mt import main

    d, _ = corpus
    model = tmp_path_factory.mktemp("cli") / "model"
    main(_train_args(d, model, "--step", "30", "--dev_mt",
                     str(d / "dev.mt"), "--eval-every", "1000", "--beam",
                     "2"))
    return model


def test_cli_train_then_translate_in_both_packages(corpus, trained):
    """cli.train_mt wrote both slots; the port's and the JAX package's
    translate CLIs read the trained checkpoint and write the same file."""
    from imagetranslate_tpu.cli.translate import main as jax_translate
    from imagetranslate_tpu_torch.cli.translate import main as translate

    d, _ = corpus
    latest = str(trained) + ".latest"
    for slot in (str(trained), latest):
        assert sorted(os.listdir(slot))[:4] == [
            "bleu.best.output", "bleu.output", "config.json", "meta.json"
        ] or sorted(os.listdir(slot)) == [
            "config.json", "meta.json", "opt_state.msgpack", "params.msgpack"]
    cfg = ckpt.load_config(latest)
    assert (cfg.hidden_size, cfg.enc_layers, cfg.dropout) == (48, 2, 0.1)
    assert ckpt.load_checkpoint(latest)[2]["step"] == 30
    args = ["--tok", str(d / "tok"), "--model", latest, "--input",
            str(d / "dev.src"), "--src", "aa", "--target", "bb", "--beam",
            "2"]
    translate(args + ["--output", str(d / "port.out"), "--device", "cpu"])
    jax_translate(args + ["--output", str(d / "jax.out")])
    got = (d / "port.out").read_text()
    assert got == (d / "jax.out").read_text()
    assert len(got.splitlines()) == 12


def test_cli_resumes_with_optimizer_state(corpus, trained, tmp_path, capsys):
    from imagetranslate_tpu_torch.cli.train_mt import main

    d, tp = corpus
    out = tmp_path / "resumed"
    main(_train_args(d, out, "--step", "2", "--pretrained",
                     str(trained) + ".latest", "--cont"))
    assert "Restored pretrained model (step 30)" in capsys.readouterr().out
    _, opt_tree, meta = ckpt.load_checkpoint(str(out) + ".latest",
                                             with_opt_state=True)
    assert meta["step"] == 2
    assert int(opt_tree["1"]["count"]) == int(opt_tree["2"]["count"]) == 32
    # without --cont only the weights carry over
    main(_train_args(d, out, "--step", "2", "--pretrained",
                     str(trained) + ".latest"))
    opt_tree = ckpt.load_checkpoint(str(out) + ".latest",
                                    with_opt_state=True)[1]
    assert int(opt_tree["1"]["count"]) == 2


@pytest.mark.parametrize("flags,module", [
    (["--lm", "x", "--train", "y"], "--lm with --train"),  # --lm alone runs
    (["--mesh", "2x1"], "module 14"),
    (["--pp-microbatches", "2"], "module 14"), (["--zero"], "module 14"),
    (["--pack"], "module 15"), (["--profile", "x"], "module 15"),
])
def test_cli_refuses_unported_flags(corpus, tmp_path, flags, module):
    from imagetranslate_tpu_torch.cli.train_mt import main

    with pytest.raises(SystemExit, match=module):
        main(_train_args(corpus[0], tmp_path / "m", "--step", "1", *flags))
    assert not (tmp_path / "m").exists()


@pytest.mark.parametrize("flags", [
    ["--image", "x"], ["--mmode", "masked"], ["--img_capacity", "40"],
    ["--max-image", "8"], ["--img-depth", "2"],
])
def test_cli_accepts_the_image_flags(corpus, tmp_path, flags):
    """The image-stream flags, once refused (ROADMAP module 9), are taken;
    without ``--train`` there is no image stream and the text model trains
    as before (tests/test_torch_port_image_mt.py drives ``--train``)."""
    from imagetranslate_tpu_torch.cli.train_mt import main

    model = tmp_path / "m"
    main(_train_args(corpus[0], model, "--step", "1", *flags))
    assert ckpt.load_checkpoint(str(model) + ".latest")[2]["step"] == 1


@pytest.mark.parametrize("flags", [
    ["--mass_train", "PREFIX"], ["--fstep", "2", "--langs", "aa,bb"],
    ["--langs", "aa,bb"], ["--ignore-mt-mass"], ["--mask", "0.3"],
    ["--bt-beam", "2"],
])
def test_cli_accepts_the_umt_flags(corpus, tmp_path, flags):
    """The flags of the MASS and back-translation phases, once refused
    (ROADMAP module 8), train: with --mass_train two steps take one MASS and
    one MT batch; --fstep adds back-translation steps."""
    from imagetranslate_tpu_torch.cli.train_mt import main

    d, tp = corpus
    if "--mass_train" in flags:
        prefix = str(tmp_path / "mono")
        assert binarize.write_mt(tp, prefix, str(d / "dev.src"),
                                 tp.token_id("<aa>")) == 12
        flags = ["--mass_train", prefix]
    model = tmp_path / "m"
    main(_train_args(d, model, "--step", "2", *flags))
    want = 4 if "--fstep" in flags else 2
    assert ckpt.load_checkpoint(str(model) + ".latest")[2]["step"] == want


@pytest.mark.parametrize("flags,message", [
    (["--embed", "50"], "multiple of the model's 12"),
    (["--fstep", "3"], "exactly two"),
    (["--fstep", "3", "--langs", "aa"], "exactly two"),
    (["--fstep", "3", "--langs", "aa,zz"], "no language token"),
    (["--mass_train", "no-such-prefix"], "matched no examples"),
])
def test_cli_names_what_is_wrong(corpus, tmp_path, flags, message):
    from imagetranslate_tpu_torch.cli.train_mt import main

    args = _train_args(corpus[0], tmp_path / "m", "--step", "1")
    if "--embed" in flags:
        args[args.index("--embed") + 1] = flags[1]
        flags = []
    with pytest.raises(SystemExit, match=message):
        main(args + list(flags))
    assert not (tmp_path / "m").exists()


def test_cli_refuses_an_empty_stream(corpus, tmp_path):
    import marshal

    from imagetranslate_tpu_torch.cli.train_mt import main

    empty = tmp_path / "empty.mt"
    empty.write_bytes(marshal.dumps([]))
    args = _train_args(corpus[0], tmp_path / "m", "--step", "1")
    args[args.index("--train_mt") + 1] = str(empty)
    with pytest.raises(SystemExit, match="no examples"):
        main(args)


_NO_JAX = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "imagetranslate_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    import imagetranslate_tpu_torch.train.trainer_mt
    from imagetranslate_tpu_torch.cli.train_mt import main
    main(sys.argv[1:])
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
""")


def test_training_cli_runs_without_jax(corpus, tmp_path):
    """cli.train_mt and train.trainer_mt import and train with jax, jaxlib,
    flax, optax and the JAX package unimportable."""
    d, _ = corpus
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO
           + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = tmp_path / "nojax"
    subprocess.run([sys.executable, "-c", _NO_JAX,
                    *_train_args(d, out, "--step", "3")],
                   check=True, cwd=REPO, env=env, timeout=300)
    assert ckpt.load_checkpoint(str(out) + ".latest")[2]["step"] == 3
