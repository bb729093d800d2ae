"""The port's host CLIs of the main path against the JAX package's:
``cli.train_tokenizer``, ``cli.create_mt_batches`` and ``cli.tokenize_file``
(the same files, byte for byte), ``decoding.scoring.forced_score`` and
``cli.score_pairs`` (the same pairs, scores within 1e-5, the shard window
and the capacity split included), and ``mmid.mmid_sim`` (the embedding and
the avg-max cosine on shared ResNet weights within 1e-4; the CLI over
folders of JPEGs).

The last test runs the new CLIs, one ``ImageMTTrainer`` tick,
``cli.extract_objects`` and ``cli.train_mt --pack --profile`` with jax,
jaxlib, flax, optax and the JAX package impossible to import.
"""

import filecmp
import marshal
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.cli import create_mt_batches as jcreate
from imagetranslate_tpu.cli import score_pairs as jscore
from imagetranslate_tpu.cli import tokenize_file as jtokfile
from imagetranslate_tpu.cli import train_tokenizer as jtrain_tok
from imagetranslate_tpu.decoding.scoring import forced_score as jforced
from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.models.resnet import ResNetGrid as JaxResNetGrid
from imagetranslate_tpu.models.seq2seq import Seq2Seq as JaxSeq2Seq
from imagetranslate_tpu_torch.cli import create_mt_batches, score_pairs
from imagetranslate_tpu_torch.cli import tokenize_file, train_tokenizer
from imagetranslate_tpu_torch.decoding.scoring import forced_score
from imagetranslate_tpu_torch.mmid import mmid_sim
from imagetranslate_tpu_torch.models.captioning import ImageSeq2Seq
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
from imagetranslate_tpu_torch.text.processor import TextProcessor
from imagetranslate_tpu_torch.train import checkpoint as ckpt
from imagetranslate_tpu_torch.train.weights import (
    CAPTION,
    random_params,
    state_dict_from_flax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["alpha", "beta", "gamma", "delta", "epsi", "zeta", "theta", "iota",
         "kappa", "lambda"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sentence(rng, n):
    return " ".join(WORDS[j] for j in rng.randint(0, len(WORDS), n))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Tagged lines for the tokenizer, the tokenizer the port's CLI trains,
    parallel and monolingual text, and a text checkpoint of its vocabulary."""
    d = tmp_path_factory.mktemp("hostcli")
    rng = np.random.RandomState(0)
    lines = []
    for i in range(120):
        lang = ("<en>", "<fa>", "<de>")[i % 3]
        sens = [_sentence(rng, rng.randint(2, 8))
                for _ in range(rng.randint(1, 4))]
        lines.append(f"{lang} " + " </s> ".join(sens) + " </s>")
    lines.insert(7, "")
    lines.insert(9, "untagged words here </s>")
    (d / "all.txt").write_text("\n".join(lines) + "\n")
    train_tokenizer.main(["--data", str(d / "all.txt"), "--vocab_size",
                          "120", "--model", str(d / "tok")])
    for name in ("src", "dst", "mono"):
        (d / f"{name}.txt").write_text("\n".join(
            _sentence(rng, rng.randint(1, 12)) for _ in range(30)) + "\n")
    tp = TextProcessor(str(d / "tok"))
    cfg = tiny_config(vocab_size=tp.vocab_size(), num_languages=3)
    ckpt.save_params(str(d / "mt"), cfg, random_params(cfg, 3))
    return d


def _tree(path):
    return {os.path.relpath(os.path.join(r, f), path): open(
        os.path.join(r, f), "rb").read()
        for r, _, fs in os.walk(path) for f in fs}


def test_train_tokenizer_writes_the_jax_files(corpus, tmp_path, capsys):
    jtrain_tok.main(["--data", str(corpus / "all.txt"), "--vocab_size",
                     "120", "--model", str(tmp_path / "jax")])
    assert _tree(str(corpus / "tok")) == _tree(str(tmp_path / "jax"))
    assert "<de> <en> <fa>" in capsys.readouterr().out
    assert TextProcessor(str(corpus / "tok")).languages == {
        "<de>": 0, "<en>": 1, "<fa>": 2}
    assert not os.path.exists(str(corpus / "all.txt") + ".tmp")


@pytest.mark.parametrize("kind", ["parallel", "mono"])
def test_create_mt_batches_writes_the_jax_bytes(corpus, tmp_path, kind):
    args = ["--tok", str(corpus / "tok"), "--src", str(corpus / "src.txt"),
            "--src-lang", "en", "--max_seq_len", "10", "--min_seq_len", "2"]
    if kind == "parallel":
        args += ["--dst", str(corpus / "dst.txt"), "--dst-lang", "fa"]
    for name, mod in (("jax", jcreate), ("port", create_mt_batches)):
        (tmp_path / name).mkdir()
        mod.main(args + ["--output", str(tmp_path / name / "out")])
    port, want = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "jax"))
    assert port == want and port
    assert sorted(port) == (["out"] if kind == "parallel" else ["out.0"])


def test_create_mt_batches_refuses_packed(corpus, tmp_path):
    """``--packed`` is no longer refused: both CLIs write the same ITR1
    shards."""
    args = ["--tok", str(corpus / "tok"), "--src", str(corpus / "src.txt"),
            "--src-lang", "en", "--packed"]
    for name, mod in (("jax", jcreate), ("port", create_mt_batches)):
        (tmp_path / name).mkdir()
        mod.main(args + ["--output", str(tmp_path / name / "o")])
    port, want = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "jax"))
    assert port == want and sorted(port) == ["o.0"]
    assert port["o.0"][:4] == b"ITR1"


@pytest.mark.parametrize("txt", [False, True])
def test_tokenize_file_writes_the_jax_lines(corpus, tmp_path, txt):
    flag = ["--txt"] if txt else []
    for name, mod in (("jax", jtokfile), ("port", tokenize_file)):
        mod.main(["--tok", str(corpus / "tok"), "--input",
                  str(corpus / "all.txt"), "--output", str(tmp_path / name),
                  *flag])
    assert filecmp.cmp(tmp_path / "port", tmp_path / "jax", shallow=False)
    out = (tmp_path / "port").read_text().splitlines()
    assert len(out) == 121 and out[0]


# ---------------- forced scores ----------------

def test_forced_score_equals_jax(corpus):
    tp = TextProcessor(str(corpus / "tok"))
    jcfg = jax_tiny_config(vocab_size=tp.vocab_size(), num_languages=3)
    cfg = tiny_config(vocab_size=tp.vocab_size(), num_languages=3)
    params = random_params(cfg, 3)
    rng = np.random.RandomState(1)
    src = rng.randint(5, tp.vocab_size(), (6, 12)).astype(np.int32)
    tgt = rng.randint(5, tp.vocab_size(), (6, 9)).astype(np.int32)
    src[:, 10:] = 0
    tgt[1, 4:] = 0
    tgt[2, 1:] = 0                         # no target token: score 0
    langs = (np.zeros(6, np.int32), np.full(6, 2, np.int32))
    want = jforced(JaxSeq2Seq(jcfg), jax.tree.map(jnp.asarray, params),
                   src, src != 0, tgt, tgt != 0, *langs)
    model = Seq2Seq(cfg)
    model.load_state_dict(state_dict_from_flax(params, cfg))
    got = forced_score(model, *(torch.as_tensor(a) for a in (
        src, src != 0, tgt, tgt != 0, *langs)))
    assert got.dtype == torch.float32 and got[2] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.fixture(scope="module")
def pairs(corpus):
    """Sentences long enough that a row holds 64 tokens, so that --capacity
    1 splits the five candidates of a source into single rows."""
    rng = np.random.RandomState(5)
    sens, cands = {}, {}
    for i in range(6):
        sens[i] = f"<en> {_sentence(rng, 80)} </s>"
        cands[i] = [100 + 5 * i + j for j in range(5)]
        for j, c in enumerate(cands[i]):
            lang = "<fa>" if j % 2 else "<de>"
            sens[c] = f"{lang} {_sentence(rng, 60 + j)} </s>"
    with open(corpus / "sens.m", "wb") as f:
        marshal.dump(sens, f)
    with open(corpus / "cands.m", "wb") as f:
        marshal.dump(cands, f)
    return corpus


@pytest.mark.parametrize("window", [[], ["--resume", "1", "--end", "5"]])
def test_score_pairs_writes_the_jax_pairs(pairs, tmp_path, window):
    """Both CLIs on the same checkpoint: the same lines, scores within
    1e-5; ``--resume 1 --end 5`` keeps the 1-based items 2..4."""
    args = ["--tok", str(pairs / "tok"), "--model", str(pairs / "mt"),
            "--data", str(pairs / "cands.m"), "--sens", str(pairs / "sens.m"),
            "--capacity", "1", *window]
    jscore.main(args + ["--output", str(tmp_path / "jax")])
    score_pairs.main(args + ["--output", str(tmp_path / "port"),
                             "--device", "cpu"])
    got = [r.split("\t") for r in (tmp_path / "port").read_text(
    ).splitlines()]
    want = [r.split("\t") for r in (tmp_path / "jax").read_text(
    ).splitlines()]
    assert len(got) == len(want) == (3 if window else 6)
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        assert abs(float(g[2]) - float(w[2])) <= 1e-5
    sens = marshal.load(open(pairs / "sens.m", "rb"))
    first = 1 if window else 0
    assert got[0][0] == sens[first]


# ---------------- mmid_sim ----------------

def test_mmid_embedding_and_avg_max_cosine_equal_jax():
    """The ResNet of a random captioner at 64 pixels, in both packages:
    the embedding of a batch and the avg-max cosine of two folders'."""
    cfg = tiny_config(vocab_size=40, img_size=64)
    variables = CAPTION.random_params(cfg, 2)
    model = ImageSeq2Seq(cfg)
    model.load_state_dict(CAPTION.state_dict_from_flax(variables, cfg))
    rng = np.random.RandomState(0)
    images = rng.standard_normal((7, 64, 64, 3)).astype(np.float32)
    jm = JaxResNetGrid(embed_dim=cfg.hidden_size, depth=1, dropout=0.0)
    grid = jm.apply({"params": variables["params"]["image_model"],
                     "batch_stats": variables["batch_stats"]["image_model"]},
                    jnp.asarray(images))
    vec = jnp.mean(grid, axis=1)
    want = np.asarray(vec / (jnp.linalg.norm(vec, axis=-1, keepdims=True)
                             + 1e-4))
    got = mmid_sim.embed(model.image_model, torch.as_tensor(images)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    jcos = float((want[:3] @ want[3:].T).max(axis=1).mean())
    np.testing.assert_allclose(mmid_sim.avg_max_cosine(got[:3], got[3:]),
                               jcos, atol=1e-4)


def _jpegs(folder, n, seed):
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        arr = rng.randint(0, 256, (40, 48, 3)).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(folder, f"{i}.jpg"))


@pytest.fixture(scope="module")
def mmid_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mmid")
    _jpegs(d / "foreign" / "gato", 2, 0)
    _jpegs(d / "foreign" / "perro", 1, 1)
    os.makedirs(d / "foreign" / "empty")
    _jpegs(d / "en" / "c" / "cat", 2, 2)
    _jpegs(d / "en" / "d", 1, 3)                 # images in the letter dir
    return d


def test_mmid_sim_cli_over_folders(mmid_dirs, tmp_path):
    out = tmp_path / "sims.tsv"
    mmid_sim.main(["--foreign", str(mmid_dirs / "foreign"), "--en",
                   str(mmid_dirs / "en"), "--output", str(out),
                   "--max-img", "2", "--device", "cpu"])
    rows = [r.split("\t") for r in out.read_text().splitlines()]
    assert [(os.path.basename(a), os.path.basename(b)) for a, b, _ in rows] \
        == [("gato", "cat"), ("perro", "cat"), ("gato", "d"), ("perro", "d")]
    assert all(-1.0 <= float(s) <= 1.0 for _, _, s in rows)


# ---------------- without JAX ----------------

_NO_JAX = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "imagetranslate_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    import torch
    torch.set_num_threads(1)
    from imagetranslate_tpu_torch.cli import (
        create_mt_batches, score_pairs, tokenize_file, train_tokenizer)
    from imagetranslate_tpu_torch.data import binarize_captions
    from imagetranslate_tpu_torch.data.binarize import load_mass
    from imagetranslate_tpu_torch.data.images import CaptionBatcher
    from imagetranslate_tpu_torch.data.loader import MassBatcher
    from imagetranslate_tpu_torch.mmid import mmid_sim
    from imagetranslate_tpu_torch.models.config import tiny_config
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train.trainer_image_mt import (
        ImageMTTrainer)

    d, corpus, mmid = sys.argv[1:4]
    train_tokenizer.main(["--data", corpus + "/all.txt", "--vocab_size",
                          "120", "--model", d + "/tok"])
    tok = ["--tok", d + "/tok"]
    create_mt_batches.main(tok + ["--src", corpus + "/mono.txt",
                                  "--src-lang", "en", "--output",
                                  d + "/mono"])
    tokenize_file.main(tok + ["--input", corpus + "/all.txt", "--output",
                              d + "/ids.txt"])
    score_pairs.main(tok + ["--model", corpus + "/mt", "--data",
                            corpus + "/cands.m", "--sens", corpus + "/sens.m",
                            "--output", d + "/pairs.tsv", "--device", "cpu"])
    mmid_sim.main(["--foreign", mmid + "/foreign", "--en", mmid + "/en",
                   "--output", d + "/sims.tsv", "--max-img", "1",
                   "--device", "cpu"])
    tp = TextProcessor(d + "/tok")
    with open(d + "/list.tsv", "w") as f:
        for i, name in enumerate(("gato/0", "gato/1", "perro/0") * 3):
            f.write(mmid + "/foreign/" + name + ".jpg\\talpha beta "
                    + "gamma " * i + "\\n")
    binarize_captions.write_from_list(tp, d + "/caps.bin", d + "/list.tsv",
                                      lang="en")
    cfg = tiny_config(vocab_size=tp.vocab_size(), num_languages=3,
                      img_size=64)
    trainer = ImageMTTrainer(cfg, tp, device="cpu")
    mass = MassBatcher(load_mass(d + "/mono"), pad_id=0)
    step = trainer.train_epoch(0, d + "/m", mass_batcher=mass,
                               img_batcher=CaptionBatcher(d + "/caps.bin", tp),
                               max_step=2, log_every=1)
    assert step == 2 and trainer.state.step == 2

    # The detector's CLI over one JPEG at 800 pixels, a random .pth; the
    # training CLI's --pack and --profile (its batches built, no step).
    from imagetranslate_tpu_torch.cli import extract_objects, train_mt
    from imagetranslate_tpu_torch.data.images import ObjectStore
    from imagetranslate_tpu_torch.train.weights import (
        random_frcnn_state_dict)
    torch.save(random_frcnn_state_dict(0), d + "/frcnn.pth")
    extract_objects.main(["--input", mmid + "/foreign/perro", "--fcnn",
                          d + "/frcnn.pth", "--output", d + "/dets.npz",
                          "--device", "cpu"])
    assert ObjectStore(d + "/dets.npz").feat_dim == 1031
    create_mt_batches.main(tok + ["--src", corpus + "/mono.txt",
                                  "--src-lang", "en", "--dst",
                                  corpus + "/mono.txt", "--dst-lang", "fa",
                                  "--output", d + "/pairs.mt"])
    train_mt.main(tok + ["--model", d + "/packed", "--train_mt",
                         d + "/pairs.mt", "--embed", "24", "--intermediate",
                         "32", "--enc", "1", "--dec", "1", "--step", "0",
                         "--pack", "--profile", d + "/prof", "--device",
                         "cpu"])
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
""")


def test_host_clis_and_an_image_mt_tick_run_without_jax(pairs, mmid_dirs,
                                                        tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO
           + os.pathsep + os.environ.get("PYTHONPATH", "")}
    subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path),
                    str(pairs), str(mmid_dirs)],
                   check=True, cwd=REPO, env=env, timeout=300)
    assert _tree(str(tmp_path / "tok")) == _tree(str(pairs / "tok"))
    assert (tmp_path / "pairs.tsv").read_text().count("\n") == 6
    assert (tmp_path / "sims.tsv").read_text().count("\n") == 4
    assert ckpt.load_checkpoint(str(tmp_path / "m") + ".latest")[2][
        "step"] == 2
    dets = np.load(tmp_path / "dets.npz")
    assert sorted(dets.files) == [str(mmid_dirs / "foreign" / "perro" / k)
                                  for k in ("0.jpg||feat", "0.jpg||lab")]
