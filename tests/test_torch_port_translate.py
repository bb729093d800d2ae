"""The port's translate CLI and checkpoints against the JAX package.

A checkpoint written by the JAX ``save_checkpoint`` is translated by the JAX
CLI and by the port's CLI (``--device cpu``): the output files must be
identical, plain and ``--verbose`` (the pattern of tests/test_translate_dp.py).
A checkpoint written by the port's ``save_params`` loads in the JAX
``load_checkpoint`` leaf for leaf. And the port, its CLI included, runs with
jax, flax and the JAX package impossible to import.
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

from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.models.seq2seq import Seq2Seq as JaxSeq2Seq
from imagetranslate_tpu.text.processor import TextProcessor
from imagetranslate_tpu.train.checkpoint import load_checkpoint, save_checkpoint
from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.train.checkpoint import (
    load_config,
    load_params,
    msgpack_dumps,
    msgpack_loads,
    save_params,
)
from imagetranslate_tpu_torch.train.weights import (
    flax_from_state_dict,
    state_dict_from_flax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["alpha", "beta", "gamma", "delta", "epsi", "zeta"]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _template(model):
    dummy = jnp.zeros((2, 8), jnp.int32)
    mask = jnp.ones((2, 8), bool)
    langs = jnp.zeros((2,), jnp.int32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), dummy, mask, dummy, mask, langs, langs))
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("translate")
    rng = np.random.RandomState(0)
    corpus = d / "c.txt"
    corpus.write_text("\n".join(
        " ".join(WORDS[j] for j in rng.randint(0, 6, rng.randint(2, 6)))
        for _ in range(120)))
    TextProcessor().train_tokenizer([str(corpus)], 200, str(d / "tok"),
                                    {"<aa>": 0, "<bb>": 1})
    tp = TextProcessor(str(d / "tok"))
    # A wider init than flax's 0.02 so the hypotheses depend on the source.
    cfg = jax_tiny_config(vocab_size=tp.vocab_size(), num_languages=2,
                          initializer_range=0.15)
    model = JaxSeq2Seq(cfg)
    params = jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32),
        jnp.ones((2, 8), bool), jnp.zeros((2, 8), jnp.int32),
        jnp.ones((2, 8), bool), jnp.zeros((2,), jnp.int32),
        jnp.zeros((2,), jnp.int32)))
    save_checkpoint(str(d / "model"), cfg, params)
    (d / "in.txt").write_text("\n".join(
        " ".join(WORDS[j] for j in rng.randint(0, 6, rng.randint(1, 7)))
        for _ in range(12)))
    return d, cfg, params


def _cli_args(d, out, verbose):
    args = ["--tok", str(d / "tok"), "--model", str(d / "model"),
            "--input", str(d / "in.txt"), "--src", "aa", "--target", "bb",
            "--output", str(out)]
    return args + (["--verbose"] if verbose else [])


@pytest.mark.parametrize("verbose", [False, True])
def test_cli_output_identical_to_jax(workdir, verbose):
    from imagetranslate_tpu.cli.translate import main as jax_main
    from imagetranslate_tpu_torch.cli.translate import main as port_main

    d = workdir[0]
    tag = "v" if verbose else "p"
    jax_main(_cli_args(d, d / f"jax_{tag}.txt", verbose))
    port_main(_cli_args(d, d / f"port_{tag}.txt", verbose)
              + ["--device", "cpu"])
    want = (d / f"jax_{tag}.txt").read_text()
    got = (d / f"port_{tag}.txt").read_text()
    assert got == want
    lines = got.splitlines()
    assert len(lines) == 12 and len(set(lines)) > 1
    assert all((" ||| " in ln) == verbose for ln in lines)


def test_port_reads_jax_checkpoint(workdir):
    d, cfg, params = workdir
    got = dict(_leaves(load_params(str(d / "model"))))
    want = dict(_leaves(params))
    assert set(got) == set(want)
    for key, leaf in want.items():
        assert got[key].dtype == leaf.dtype, key
        np.testing.assert_array_equal(got[key], leaf, key)
    assert load_config(str(d / "model")).to_json() == cfg.to_json()


def test_port_checkpoint_loads_in_jax(workdir, tmp_path):
    d, jcfg, params = workdir
    cfg = Seq2SeqConfig.from_json(jcfg.to_json())
    sd = state_dict_from_flax(params, cfg)
    save_params(str(tmp_path), cfg, flax_from_state_dict(sd, cfg), step=7)
    loaded, _, meta = load_checkpoint(str(tmp_path),
                                      _template(JaxSeq2Seq(jcfg)))
    assert meta == {"step": 7}
    got = dict(_leaves(jax.device_get(loaded)))
    for key, leaf in _leaves(params):
        np.testing.assert_array_equal(got[key], leaf, key)


def test_msgpack_round_trip_dtypes():
    """bf16, fp8 and int leaves survive the writer and the reader, and flax
    reads what the writer wrote."""
    from flax import serialization

    tree = {"a": {"w": torch.randn(3, 5).bfloat16(),
                  "i": torch.arange(4, dtype=torch.int32)},
            "f8": torch.randn(2, 2).to(torch.float8_e4m3fn),
            "x" * 40: torch.randn(300)}
    back = msgpack_loads(msgpack_dumps(tree))
    assert torch.equal(back["a"]["w"], tree["a"]["w"])
    assert torch.equal(back["a"]["i"], tree["a"]["i"])
    assert torch.equal(back["f8"].view(torch.uint8),
                       tree["f8"].view(torch.uint8))
    restored = serialization.msgpack_restore(msgpack_dumps(tree))
    np.testing.assert_array_equal(restored["x" * 40], tree["x" * 40].numpy())


_NO_JAX = textwrap.dedent("""
    import importlib.abc, importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "imagetranslate_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    import imagetranslate_tpu_torch
    for mod in pkgutil.walk_packages(imagetranslate_tpu_torch.__path__,
                                     "imagetranslate_tpu_torch."):
        importlib.import_module(mod.name)
    from imagetranslate_tpu_torch.cli.translate import main
    main(sys.argv[1:])
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
""")


def test_port_runs_without_jax(workdir):
    """Every port module imports (the training CLI and trainer too), and the
    CLI translates, with jax, jaxlib, flax, optax and the JAX package
    unimportable; and with ``sys.modules['jax'] = None`` the CLI modules
    import cleanly. The output equals the in-process
    port's."""
    d = workdir[0]
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    out = d / "nojax.txt"
    subprocess.run([sys.executable, "-c", _NO_JAX,
                    *_cli_args(d, out, False), "--device", "cpu"],
                   check=True, cwd=REPO, env=env, timeout=300)
    subprocess.run([sys.executable, "-c",
                    "import sys; sys.modules['jax'] = None; "
                    "sys.modules['flax'] = None; "
                    "sys.modules['optax'] = None; "
                    "sys.modules['imagetranslate_tpu'] = None; "
                    "import imagetranslate_tpu_torch.cli.translate; "
                    "import imagetranslate_tpu_torch.cli.train_mt; "
                    "import imagetranslate_tpu_torch.train.trainer_mt; "
                    "import imagetranslate_tpu_torch.cli.caption; "
                    "import imagetranslate_tpu_torch.models.captioning; "
                    "import imagetranslate_tpu_torch.models.resnet; "
                    "import imagetranslate_tpu_torch.data.images; "
                    "import imagetranslate_tpu_torch.ops.decode_attention; "
                    "import imagetranslate_tpu_torch.cli.train_captioning; "
                    "import imagetranslate_tpu_torch.train.trainer_caption; "
                    "import imagetranslate_tpu_torch.data.binarize_captions; "
                    "import "
                    "imagetranslate_tpu_torch.cli.binarize_captions_from_list; "
                    "import imagetranslate_tpu_torch.cli.binarize_coco_data; "
                    "import "
                    "imagetranslate_tpu_torch.cli.binarize_image_caption_data"],
                   check=True, cwd=REPO, env=env, timeout=120)
    from imagetranslate_tpu_torch.cli.translate import main as port_main

    port_main(_cli_args(d, d / "inproc.txt", False) + ["--device", "cpu"])
    assert out.read_text() == (d / "inproc.txt").read_text()
