"""The port's caption CLI, image pipeline and caption checkpoints against the
JAX package's: the ``CAPTION`` bridge round-trips and keeps dtypes; a caption
checkpoint (``{"params", "batch_stats"}``) written by either package loads in
the other; ``load_image`` and ``ImageFolderBatcher`` give the JAX package's
arrays on JPEGs written here (both packages on their default path: the
native decoder first, Pillow for what it does not take); both ``cli.caption`` write the same file from
one checkpoint and one folder; ``--obj`` without ``--fcnn`` stops with the
JAX CLI's message; and the
port's CLI captions with jax, flax and the JAX package impossible to import.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.data import images as jax_images
from imagetranslate_tpu.models.captioning import ImageSeq2Seq as JaxModel
from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.text.processor import TextProcessor
from imagetranslate_tpu.train.checkpoint import load_checkpoint, save_checkpoint
from imagetranslate_tpu_torch.cli import caption as port_cli
from imagetranslate_tpu_torch.data import images as port_images
from imagetranslate_tpu_torch.models.captioning import ImageSeq2Seq
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.train.checkpoint import (
    load_variables,
    save_checkpoint as port_save_checkpoint,
)
from imagetranslate_tpu_torch.train.weights import CAPTION

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64
N_IMAGES = 11          # one batch of 8 and a tail of 3, padded to 8 rows
WORDS = ["alpha", "beta", "gamma", "delta", "epsi", "zeta"]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("caption")
    rng = np.random.RandomState(0)
    corpus = d / "c.txt"
    corpus.write_text("\n".join(
        " ".join(WORDS[j] for j in rng.randint(0, 6, rng.randint(2, 6)))
        for _ in range(120)))
    TextProcessor().train_tokenizer([str(corpus)], 200, str(d / "tok"),
                                    {"<aa>": 0, "<bb>": 1})
    tp = TextProcessor(str(d / "tok"))
    folder = d / "images"
    folder.mkdir()
    # Smooth images of several sizes and both orientations, one grey-scale,
    # one smaller than the crop, one unreadable file, one skipped png.
    sizes = [(320, 240), (240, 320), (256, 256), (500, 375), (100, 80),
             (64, 64), (40, 30), (301, 299), (333, 222)]
    for i, (w, h) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        planes = [127 + 120 * np.sin(xx / (7 + c + i) + yy / (11 + 2 * c))
                  for c in range(3)]
        arr = np.stack(planes, axis=-1).astype(np.uint8)
        Image.fromarray(arr).save(folder / f"img{i:02d}.jpg", quality=90)
    Image.fromarray(arr[:, :, 0]).save(folder / "img09_grey.jpeg")
    (folder / "img10_broken.jpg").write_bytes(b"not a jpeg")
    Image.fromarray(arr).save(folder / "skipped.png")
    assert len([p for p in os.listdir(folder)
                if not p.endswith(".png")]) == N_IMAGES

    kw = dict(vocab_size=tp.vocab_size(), num_languages=2, img_size=IMG,
              initializer_range=0.3)
    cfg = tiny_config(**kw)
    variables = CAPTION.random_params(cfg, 0)
    save_checkpoint(str(d / "model"), jax_tiny_config(**kw), variables)
    return d, cfg, variables, tp


def _template(jcfg):
    model = JaxModel(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((2, jcfg.img_size, jcfg.img_size, 3), jnp.float32),
        jnp.zeros((2, 8), jnp.int32), jnp.ones((2, 8), bool),
        jnp.zeros((2,), jnp.int32), method=JaxModel.init_everything))
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), dict(shapes))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_caption_bridge_round_trips_and_keeps_dtypes(dtype):
    cfg = tiny_config(vocab_size=48, img_size=IMG, use_obj=True,
                      lang_dec=True)
    variables = jax.tree.map(lambda a: torch.tensor(a).to(dtype),
                             CAPTION.random_params(cfg, 3))
    sd = CAPTION.state_dict_from_flax(variables, cfg)
    assert all(v.dtype == dtype and v.is_contiguous() for v in sd.values())
    model = ImageSeq2Seq(cfg)
    assert set(sd) == set(model.state_dict())
    back = dict(_leaves(jax.tree.map(
        lambda t: t.float().numpy(), CAPTION.flax_from_state_dict(sd, cfg))))
    want = dict(_leaves(jax.tree.map(lambda t: t.float().numpy(), variables)))
    assert set(back) == set(want)
    for key, leaf in want.items():
        np.testing.assert_array_equal(back[key], leaf, key)
    # A parameter-shaped tree (no batch_stats: an optimizer moment) crosses
    # too, without the running statistics.
    moment = CAPTION.state_dict_from_flax(variables["params"], cfg)
    assert set(sd) - set(moment) == {k for k in sd if "running_" in k}


def test_port_reads_jax_caption_checkpoint(workdir):
    d, cfg, variables, _ = workdir
    got = dict(_leaves(load_variables(str(d / "model"))))
    want = dict(_leaves(variables))
    assert set(got) == set(want)
    assert any(k.startswith("/batch_stats/") for k in got)
    for key, leaf in want.items():
        np.testing.assert_array_equal(got[key], leaf, key)


def test_port_caption_checkpoint_loads_in_jax(workdir, tmp_path):
    d, cfg, variables, _ = workdir
    model = ImageSeq2Seq(cfg)
    model.load_state_dict(CAPTION.state_dict_from_flax(variables, cfg))
    port_save_checkpoint(str(tmp_path), cfg,
                         CAPTION.flax_from_state_dict(model.state_dict(),
                                                      cfg), step=5)
    from imagetranslate_tpu.train.checkpoint import load_config

    jcfg = load_config(str(tmp_path))
    loaded, _, meta = load_checkpoint(str(tmp_path), _template(jcfg))
    assert meta == {"step": 5}
    got = dict(_leaves(jax.device_get(loaded)))
    for key, leaf in _leaves(variables):
        np.testing.assert_array_equal(got[key], leaf, key)
    # ... and the JAX model encodes an image with it as the port does.
    images = np.random.RandomState(1).randint(
        0, 256, (2, IMG, IMG, 3)).astype(np.uint8)
    want = JaxModel(jcfg).apply(loaded, jnp.asarray(images),
                                method=JaxModel.encode_images)
    with torch.no_grad():
        grid = model.eval().encode_images(torch.tensor(images))
    np.testing.assert_allclose(grid.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(size=IMG), dict(size=IMG, raw=True), dict(size=224, raw=True),
    dict(size=96, resize_min=96, raw=True),
    dict(size=300, resize_min=256, raw=True),     # the crop exceeds the image
], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_load_image_matches_jax(workdir, kw):
    folder = workdir[0] / "images"
    for name in sorted(os.listdir(folder)):
        got = port_images.load_image(str(folder / name), **kw)
        want = jax_images.load_image(str(folder / name), **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, name)
    assert got.shape == (kw["size"], kw["size"], 3)


def test_normalize_uint8_matches_jax_and_host_path():
    u8 = np.random.RandomState(0).randint(0, 256, (2, 8, 8, 3)).astype(
        np.uint8)
    got = port_images.normalize_uint8(torch.tensor(u8)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_images.normalize_uint8(jnp.asarray(u8))),
        atol=1e-6, rtol=1e-6)
    host = (u8.astype(np.float32) / 255.0
            - port_images.IMAGENET_MEAN) / port_images.IMAGENET_STD
    np.testing.assert_allclose(got, host, atol=1e-6, rtol=1e-6)


def test_image_folder_batcher_matches_jax(workdir):
    folder = str(workdir[0] / "images")
    got = list(port_images.ImageFolderBatcher(folder, 8, 1, 7, img_size=IMG))
    want = list(jax_images.ImageFolderBatcher(folder, 8, 1, 7, img_size=IMG))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["paths"] == w["paths"]
        assert not any(p.endswith(".png") for p in g["paths"])
        for key in ("images", "first_tokens", "tgt_langs"):
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key], key)
    # The tail: 3 real files in 8 rows, the padding a copy of the first.
    assert len(got[1]["paths"]) == 3 and got[1]["images"].shape[0] == 8
    np.testing.assert_array_equal(got[1]["images"][5], got[1]["images"][0])
    # The unreadable file became a black image.
    assert not got[1]["images"][2].any()


def _cli_args(d, out):
    return ["--tok", str(d / "tok"), "--model", str(d / "model"),
            "--input", str(d / "images"), "--target", "bb",
            "--output", str(out), "--batch", "8", "--max_len", "12",
            "--beam", "3"]


def test_cli_output_identical_to_jax(workdir):
    from imagetranslate_tpu.cli.caption import main as jax_main

    d = workdir[0]
    jax_main(_cli_args(d, d / "jax.tsv"))
    port_cli.main(_cli_args(d, d / "port.tsv") + ["--device", "cpu"])
    got = (d / "port.tsv").read_text()
    assert got == (d / "jax.tsv").read_text()
    lines = got.splitlines()
    assert len(lines) == N_IMAGES
    paths, captions = zip(*(ln.split("\t") for ln in lines))
    assert list(paths) == sorted(paths) and len(set(captions)) > 1


def test_caption_batches_takes_a_callers_batcher_and_objects(workdir):
    """The decode loop alone over dicts built from arrays, with and without
    precomputed detections (the object stream of ``--obj``)."""
    import io

    d, cfg, _, tp = workdir
    ocfg = dataclasses.replace(cfg, use_obj=True)
    model = ImageSeq2Seq(ocfg)
    model.load_state_dict(CAPTION.state_dict_from_flax(
        CAPTION.random_params(ocfg, 0), ocfg))
    model.eval()
    rng = np.random.RandomState(0)
    batch = {"paths": ["a.jpg", "b.jpg", "c.jpg"],
             "images": rng.randint(0, 256, (8, IMG, IMG, 3)).astype(np.uint8),
             "first_tokens": np.full((8,), tp.token_id("<bb>"), np.int32),
             "tgt_langs": np.ones((8,), np.int32)}
    plain = io.StringIO()
    assert port_cli.caption_batches(model, tp, [batch], plain, beam_width=2,
                                    max_len=10) == 3
    with_obj = io.StringIO()
    labels = np.zeros((8, 4), np.int32)
    labels[:, :2] = rng.randint(1, 91, (8, 2))
    port_cli.caption_batches(
        model, tp, [{**batch, "object_labels": labels, "box_features":
                     rng.standard_normal((8, 4, 1031)).astype(np.float32)}],
        with_obj, beam_width=2, max_len=10)
    for text in (plain.getvalue(), with_obj.getvalue()):
        assert [ln.split("\t")[0] for ln in text.splitlines()] == batch[
            "paths"]
    assert plain.getvalue() != with_obj.getvalue()


def test_obj_flag_is_refused_with_a_message(workdir, tmp_path):
    """``--obj`` runs the detector (tests/test_torch_port_detector.py);
    without ``--fcnn`` it stops with the JAX CLI's message."""
    d = workdir[0]
    with pytest.raises(SystemExit) as info:
        port_cli.main(_cli_args(d, tmp_path / "o.tsv") + ["--obj"])
    assert str(info.value) == "--obj needs --fcnn <state_dict.pth>"
    assert not (tmp_path / "o.tsv").exists()


def test_cli_defaults_are_the_jax_clis():
    from imagetranslate_tpu.cli.caption import get_parser as jax_parser

    argv = ["--input", "i", "--target", "t", "--output", "o", "--tok", "k",
            "--model", "m"]
    want = vars(jax_parser().parse_args(argv))
    got = vars(port_cli.get_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want


_NO_JAX = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "imagetranslate_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    from imagetranslate_tpu_torch.cli.caption import main
    main(sys.argv[1:])
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
""")


def test_caption_cli_runs_without_jax(workdir):
    d = workdir[0]
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    out = d / "nojax.tsv"
    subprocess.run([sys.executable, "-c", _NO_JAX, *_cli_args(d, out),
                    "--device", "cpu"], check=True, cwd=REPO, env=env,
                   timeout=300)
    port_cli.main(_cli_args(d, d / "inproc.tsv") + ["--device", "cpu"])
    assert out.read_text() == (d / "inproc.tsv").read_text()
