"""The port's LM path through its CLIs, on the CPU at a tiny size, against
the JAX package: ``cli.create_batches`` -> ``cli.train_lm`` (plain and
``--reformer --size 1``) -> ``cli.train_mt --lm`` -> ``cli.translate``
through files; LM checkpoints crossing both ways (the JAX package loads what
the port's ``cli.train_lm`` wrote, optimizer state included, and gives the
same dev loss under the same mask draws, rtol 1e-4; and the reverse); the
graft of ``--lm``; what the CLIs refuse; and the new CLI modules importing
and running with jax, flax, optax and the JAX package impossible to import.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.data.loader import DocBlockDataset as JaxDocBlockDataset
from imagetranslate_tpu.models.lm import LM as JaxLM
from imagetranslate_tpu.models.longdoc import LongDocLM as JaxLongDocLM
from imagetranslate_tpu.train import checkpoint as jckpt
from imagetranslate_tpu.train import optimizer as jopt
from imagetranslate_tpu.train import step as jstep
from imagetranslate_tpu_torch.cli import create_batches, train_lm, train_mt
from imagetranslate_tpu_torch.cli import translate as translate_cli
from imagetranslate_tpu_torch.data.binarize import write_mt
from imagetranslate_tpu_torch.data.loader import DocBlockDataset
from imagetranslate_tpu_torch.models.lm import LM
from imagetranslate_tpu_torch.ops.masking import MLMDraws
from imagetranslate_tpu_torch.text.processor import TextProcessor
from imagetranslate_tpu_torch.train import checkpoint as ckpt
from imagetranslate_tpu_torch.train import step as pstep
from imagetranslate_tpu_torch.train import weights
from imagetranslate_tpu_torch.train.trainer_lm import LMTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["alpha", "beta", "gamma", "delta", "epsi", "zeta", "eta", "theta"]
SEQ_LEN, ROWS = 32, 4
WIDTH = ["--enc", "2", "--embed", "24", "--intermediate", "48",
         "--dtype", "float32"]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """At these sizes one intra-op thread is the fastest, and the file's time
    stays steady when other test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _docs(path, n, seed):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            sents = [" ".join(WORDS[j] for j in rng.randint(
                0, len(WORDS), rng.randint(3, 9)))
                for _ in range(rng.randint(2, 9))]
            f.write(f"<{'aa' if i % 2 else 'bb'}> "
                    + " </s> ".join(sents) + " </s>\n")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Documents, a two-language tokenizer, train and dev blocks written by
    the port's ``cli.create_batches``, and an LM trained by the port's
    ``cli.train_lm`` for 6 steps with a dev set."""
    d = tmp_path_factory.mktemp("lmcli")
    _docs(d / "train.txt", 40, 0)
    _docs(d / "dev.txt", 8, 1)
    TextProcessor().train_tokenizer([str(d / "train.txt")], 150,
                                    str(d / "tok"), {"<aa>": 0, "<bb>": 1})
    for name in ("train", "dev"):
        create_batches.main(["--data", str(d / f"{name}.txt"), "--cache",
                             str(d / name), "--tok", str(d / "tok"),
                             "--seq_len", str(SEQ_LEN), "--block", "16"])
    train_lm.main(["--tok", str(d / "tok"), "--model", str(d / "lm"),
                   "--train", str(d / "train"), "--dev", str(d / "dev"),
                   "--step", "6", "--batch", str(ROWS), "--warmup", "4",
                   "--lr", "0.002", "--dropout", "0.0", "--device", "cpu",
                   *WIDTH])
    return d


def _jax_template(model, T=8):
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, T), jnp.int32),
        jnp.ones((2, T), bool), jnp.zeros((2,), jnp.int32)))
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


def _jax_draws(rng, shape, n_specials, vocab) -> MLMDraws:
    r_sel, r_corrupt = jax.random.split(rng)
    r_choice, r_rand = jax.random.split(r_corrupt)
    return MLMDraws(*(torch.tensor(np.asarray(a)) for a in (
        jax.random.uniform(r_sel, shape), jax.random.uniform(r_choice, shape),
        jax.random.randint(r_rand, shape, n_specials, vocab))))


def _dev_losses(ckpt_dir, dev_dir, tp):
    """The dev loss of the LM checkpoint ``ckpt_dir`` as the JAX package's
    ``LMTrainer.validate_and_save`` computes it, and as the port computes it
    from the same checkpoint under the same draws."""
    jcfg = jckpt.load_config(ckpt_dir)
    jmodel = JaxLM(jcfg)
    jparams, _, _ = jckpt.load_checkpoint(ckpt_dir, _jax_template(jmodel))
    kw = dict(mask_prob=0.15, n_specials=len(tp.special_tokens),
              mask_id=tp.mask_token_id())
    jeval = jstep.make_mlm_eval_step(jmodel, jcfg, **kw)
    cfg = ckpt.load_config(ckpt_dir)
    model = LM(cfg, param_dtype=torch.float32)
    model.load_state_dict(weights.LM.state_dict_from_flax(
        ckpt.load_params(ckpt_dir), cfg))
    evaluate = pstep.make_mlm_eval_step(model, cfg, **kw)
    jtotal = jcount = ptotal = pcount = 0.0
    rng = jax.random.PRNGKey(0)
    for jb, b in zip(JaxDocBlockDataset(dev_dir).batches(ROWS),
                     DocBlockDataset(dev_dir).batches(ROWS)):
        rng, erng = jax.random.split(rng)
        s, n = jeval(jparams, {k: jnp.asarray(v) for k, v in jb.items()}, erng)
        jtotal, jcount = jtotal + float(s), jcount + float(n)
        s, n = evaluate(pstep.lm_batch_to_device(b, CPU), None,
                        draws=_jax_draws(erng, b["texts"].shape,
                                         kw["n_specials"], cfg.vocab_size))
        ptotal, pcount = ptotal + s.item(), pcount + n.item()
    assert jcount == pcount > 0
    return jtotal / jcount, ptotal / pcount


def test_create_batches_and_train_lm_wrote_their_files(work):
    tp = TextProcessor(str(work / "tok"))
    ds = DocBlockDataset(str(work / "train"))
    assert len(ds) > 16 and ds.file_count >= 2 and len(ds[0]) == SEQ_LEN
    assert {ds.lang_at(i) for i in range(len(ds))} == {0, 1}
    for slot in ("lm", "lm.latest"):
        cfg = ckpt.load_config(str(work / slot))
        assert (cfg.vocab_size, cfg.hidden_size, cfg.enc_layers,
                cfg.max_position_embeddings) == (tp.vocab_size(), 24, 2, 512)
        params, opt_tree, meta = ckpt.load_checkpoint(str(work / slot),
                                                      with_opt_state=True)
        assert set(params["params"]) == {"embeddings", "encoder", "out_bias"}
        assert meta["step"] == 6 and int(opt_tree["1"]["count"]) == 6
        # The rolling slot is written before the epoch's validation, with the
        # best dev loss so far (none yet), as the JAX trainer writes it.
        assert np.isfinite(meta["best_metric"]) == (slot == "lm")
        assert params["params"]["out_bias"].abs().max() > 0   # it trained


def test_jax_loads_the_ports_lm_checkpoint(work):
    """Parameters and optimizer state load into the JAX package's templates,
    and both packages give the same dev loss from it."""
    tp = TextProcessor(str(work / "tok"))
    path = str(work / "lm")
    jcfg = jckpt.load_config(path)
    jmodel = JaxLM(jcfg)
    tmpl = _jax_template(jmodel)
    joptim = jopt.build_optimizer(lr=2e-3, warmup_updates=4, clip_norm=1.0)
    params, opt_state, meta = jckpt.load_checkpoint(path, tmpl,
                                                    joptim.init(tmpl))
    assert meta["step"] == 6 and opt_state is not None
    port = ckpt.load_params(path)["params"]
    np.testing.assert_array_equal(np.asarray(params["params"]["out_bias"]),
                                  port["out_bias"].numpy())
    jloss, ploss = _dev_losses(path, str(work / "dev"), tp)
    np.testing.assert_allclose(ploss, jloss, rtol=1e-4)
    # The loss the port's own validation saved with the checkpoint is a dev
    # loss of the same model under the port's own draws: close, not equal.
    assert abs(meta["best_metric"] - ploss) < 0.5


def test_port_loads_the_jax_lm_checkpoint(work, tmp_path, capsys):
    """The JAX package's ``cli.train_lm`` writes a checkpoint; the port reads
    it, gives the same dev loss, and goes on training from it through
    ``--pretrained``."""
    from imagetranslate_tpu.cli.train_lm import main as jax_train_lm

    tp = TextProcessor(str(work / "tok"))
    jax_train_lm(["--tok", str(work / "tok"), "--model", str(tmp_path / "jlm"),
                  "--train", str(work / "train"), "--dev", str(work / "dev"),
                  "--step", "2", "--batch", str(ROWS), "--warmup", "4",
                  "--dropout", "0.0", *WIDTH])
    path = str(tmp_path / "jlm")
    jloss, ploss = _dev_losses(path, str(work / "dev"), tp)
    np.testing.assert_allclose(ploss, jloss, rtol=1e-4)
    capsys.readouterr()
    train_lm.main(["--tok", str(work / "tok"), "--model",
                   str(tmp_path / "cont"), "--train", str(work / "train"),
                   "--step", "2", "--batch", str(ROWS), "--warmup", "4",
                   "--pretrained", path, "--device", "cpu", *WIDTH])
    out = capsys.readouterr().out
    assert "Restored pretrained LM" in out and "Finished Training!" in out
    got = ckpt.load_params(str(tmp_path / "cont.latest"))["params"]
    start = ckpt.load_params(path)["params"]
    word = lambda p: p["embeddings"]["word"]["embedding"]     # noqa: E731
    assert 0 < (word(got) - word(start)).abs().max() < 0.05


def test_train_lm_reformer(work, tmp_path):
    """``--reformer --size 1`` trains the long-document LM on 128-token
    blocks; the JAX package loads its checkpoint into ``LongDocLM``."""
    create_batches.main(["--data", str(work / "train.txt"), "--cache",
                         str(tmp_path / "blocks"), "--tok", str(work / "tok"),
                         "--seq_len", "128"])
    model = str(tmp_path / "longdoc")
    train_lm.main(["--tok", str(work / "tok"), "--model", model, "--train",
                   str(tmp_path / "blocks"), "--dev", str(tmp_path / "blocks"),
                   "--step", "3", "--batch", "2", "--warmup", "4",
                   "--reformer", "--size", "1", "--dtype", "float32",
                   "--device", "cpu"])
    cfg = ckpt.load_config(model)
    assert (cfg.hidden_size, cfg.num_heads, cfg.enc_layers, cfg.dec_layers,
            cfg.max_position_embeddings) == (64, 1, 4, 0, 4096)
    _, opt_tree, meta = ckpt.load_checkpoint(model, with_opt_state=True)
    assert meta["step"] == 3 and int(opt_tree["1"]["count"]) == 3
    jcfg = jckpt.load_config(model)
    jparams, _, _ = jckpt.load_checkpoint(
        model, _jax_template(JaxLongDocLM(jcfg), T=128))
    port = ckpt.load_params(model)["params"]
    np.testing.assert_array_equal(
        np.asarray(jparams["params"]["layers_3"]["out"]["kernel"]),
        port["layers_3"]["out"]["kernel"].numpy())


@pytest.mark.parametrize("tie", [False, True])
def test_train_mt_lm_graft_and_translate(work, tmp_path, capsys, tie):
    """``cli.train_mt --lm`` starts the embeddings, the encoder and the
    untied output layer from the LM (what the JAX CLI's graft copies;
    the flow of tests/test_lm_graft.py), then ``cli.translate`` decodes with
    the result."""
    d = tmp_path
    tp = TextProcessor(str(work / "tok"))
    rng = np.random.RandomState(3)
    lines = [" ".join(WORDS[j] for j in rng.randint(0, len(WORDS), 4))
             for _ in range(16)]
    (d / "s.txt").write_text("\n".join(lines) + "\n")
    write_mt(tp, str(d / "train.mt"), str(d / "s.txt"), tp.token_id("<aa>"),
             str(d / "s.txt"), tp.token_id("<bb>"))
    # --step 0 takes no train step: the checkpoint below is the graft itself.
    args = ["--tok", str(work / "tok"), "--model", str(d / "model"),
            "--train_mt", str(d / "train.mt"), "--lm", str(work / "lm"),
            "--dec", "2", "--warmup", "10", "--device", "cpu", *WIDTH]
    train_mt.main(args + ["--step", "0"] + (["--tie"] if tie else []))
    assert ("Initialized encoder/embeddings/output from the MLM LM"
            in capsys.readouterr().out)
    assert not os.path.exists(str(d / "model.latest"))
    train_mt.main(args + ["--step", "2"] + (["--tie"] if tie else []))
    lm = ckpt.load_params(str(work / "lm"))["params"]
    got = ckpt.load_params(str(d / "model.latest"))["params"]
    # Two tiny steps at lr 1e-4 leave the grafted weights near the LM's; a
    # fresh init (std 0.02) would be far from a trained LM's tables.
    for a, b in ((got["embeddings"]["word"]["embedding"],
                  lm["embeddings"]["word"]["embedding"]),
                 (got["encoder"]["layers_1"]["ffn"]["output"]["kernel"],
                  lm["encoder"]["layers_1"]["ffn"]["output"]["kernel"])):
        assert (a - b).abs().max() < 2e-3
    if tie:
        assert "output_layers_0" not in got
    else:
        proj = got["output_layers_0"]["proj"]
        assert (proj["kernel"]
                - lm["embeddings"]["word"]["embedding"].T).abs().max() < 2e-3
        assert (proj["bias"] - lm["out_bias"]).abs().max() < 2e-3
    (d / "in.txt").write_text("\n".join(lines[:5]) + "\n")
    translate_cli.main(["--tok", str(work / "tok"), "--model",
                        str(d / "model.latest"), "--input", str(d / "in.txt"),
                        "--output", str(d / "out.txt"), "--src", "aa",
                        "--target", "bb", "--device", "cpu"])
    assert len((d / "out.txt").read_text().splitlines()) == 5


def test_graft_is_exactly_the_lms_subtrees(work):
    """Before any step: the trainer's tree after the graft holds the LM's
    ``embeddings`` and ``encoder`` leaf for leaf."""
    from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
    from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer

    tp = TextProcessor(str(work / "tok"))
    lm = ckpt.load_params(str(work / "lm"))["params"]
    cfg = Seq2SeqConfig(vocab_size=tp.vocab_size(), num_languages=2,
                        hidden_size=24, intermediate_size=48, enc_layers=2,
                        dec_layers=1, dtype="float32")
    trainer = MTTrainer(cfg, tp, device="cpu")
    p = dict(trainer.params_tree()["params"])
    p["embeddings"], p["encoder"] = lm["embeddings"], lm["encoder"]
    trainer.set_reference_params({"params": p})
    sd = trainer.model.state_dict()
    want = weights.LM.state_dict_from_flax({"params": lm}, cfg)
    for key, leaf in want.items():
        if key != "out_bias":
            assert torch.equal(sd[key], leaf), key


def test_lm_trainer_validation_uses_the_same_masks_each_time(work):
    tp = TextProcessor(str(work / "tok"))
    cfg = ckpt.load_config(str(work / "lm"))
    trainer = LMTrainer(cfg, tp, device="cpu",
                        params=ckpt.load_params(str(work / "lm")))
    dev = DocBlockDataset(str(work / "dev"), load_all=True)
    out = str(work / "unused")
    trainer.best_dev_loss = -1.0                       # nothing is saved
    losses = [trainer.validate_and_save(out, dev, ROWS) for _ in range(2)]
    assert losses[0] == losses[1] and not os.path.exists(out)
    with open(work / "lm" / "meta.json") as f:
        assert abs(json.load(f)["best_metric"] - losses[0]) < 1e-5


def test_clis_refuse_what_is_not_ported(work, tmp_path):
    base = ["--tok", str(work / "tok"), "--model", str(tmp_path / "m"),
            "--train", str(work / "train"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="module 14"):
        train_lm.main(base + ["--mesh", "4x2"])
    with pytest.raises(SystemExit, match="multiple of 12"):
        train_lm.main(base + ["--embed", "32"])
    with pytest.raises(SystemExit, match="module 15"):
        create_batches.main(["--data", str(work / "dev.txt"), "--cache",
                             str(tmp_path / "c"), "--tok", str(work / "tok"),
                             "--packed"])
    with pytest.raises(SystemExit, match="--lm with --train"):
        train_mt.main(["--tok", str(work / "tok"), "--model",
                       str(tmp_path / "m"), "--lm", str(work / "lm"),
                       "--train", "images", "--device", "cpu"])
    with pytest.raises(ValueError, match="moe_top_k"):
        ckpt.load_config(str(work / "lm")).__class__(vocab_size=10,
                                                     moe_experts=2,
                                                     moe_top_k=3)
    with pytest.raises(NotImplementedError, match="module 14"):
        LMTrainer(ckpt.load_config(str(work / "lm")),
                  TextProcessor(str(work / "tok")), mesh=object(),
                  device="cpu")


_NO_JAX = textwrap.dedent("""
    import importlib.abc, importlib, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "imagetranslate_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    for name in ("cli.train_lm", "cli.create_batches", "models.lm",
                 "models.longdoc", "ops.flash_attention", "train.trainer_lm",
                 "train.trainer_longdoc"):
        importlib.import_module("imagetranslate_tpu_torch." + name)
    from imagetranslate_tpu_torch.cli import create_batches, train_lm
    tok, data, out = sys.argv[1:4]
    create_batches.main(["--data", data, "--cache", out + "/blocks", "--tok",
                         tok, "--seq_len", "32"])
    train_lm.main(["--tok", tok, "--model", out + "/lm", "--train",
                   out + "/blocks", "--step", "2", "--batch", "4", "--enc",
                   "1", "--embed", "12", "--intermediate", "24", "--dtype",
                   "float32", "--device", "cpu"])
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
""")


def test_lm_clis_run_without_jax(work, tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    subprocess.run([sys.executable, "-c", _NO_JAX, str(work / "tok"),
                    str(work / "dev.txt"), str(tmp_path)],
                   check=True, cwd=REPO, env=env, timeout=300)
    assert ckpt.load_checkpoint(str(tmp_path / "lm.latest"))[2]["step"] == 2
