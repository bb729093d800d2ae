"""The port's Faster R-CNN, its weight bridge and ``cli.caption --obj``
against the JAX package's (imagetranslate_tpu/models/detector.py,
train/torch_import.py::import_torchvision_frcnn, cli/caption.py), on the CPU
in fp32, with one random torchvision state_dict
(``weights.random_frcnn_state_dict``) shared by both sides: the JAX side
takes it through ``import_torchvision_frcnn``, with no flax ``init``.

- ``make_anchors``, ``decode_deltas`` (the 4.135 clip) and ``fpn_levels``
  (the 448 x 448 octave boundary) against the JAX functions;
- the FPN at 112 pixels, where 7 -> 4 is not an exact halving (JAX's
  nearest resize has half-pixel centres: ``nearest-exact``);
- the whole ``FasterRCNN`` at B=2, 112 pixels, pre-NMS top-k 200, post-NMS
  64, 12 detections, against the JAX module under ``vmap`` on three uint8
  batches: random pixels; an image with a constant half under weights
  whose objectness logits all tie (the top-k and the RPN's NMS choose by
  index: a stable sort, the first argmax); a constant image under weights
  whose proposals collapse onto the whole image (most proposal slots
  unfilled: zero boxes through RoIAlign and the box head). Labels,
  ``valid`` and counts exact; scores rtol 2e-3 / atol 1e-4, boxes 2e-3 /
  5e-2, features 1e-2 (tests/test_detector_e2e.py's tolerances);
- ``DETECTOR`` round trips through ``import_torchvision_frcnn`` exactly,
  and ``load_torchvision_frcnn`` reads both key spellings, wrappers and
  ``num_batches_tracked``;
- ``cli.caption --obj --fcnn`` of both packages write the same file, and
  ``--obj`` without ``--fcnn`` stops both with the same message.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.models import detector as jdet
from imagetranslate_tpu.train.torch_import import import_torchvision_frcnn
from imagetranslate_tpu_torch.models import detector as pdet
from imagetranslate_tpu_torch.train.weights import (
    DETECTOR,
    load_torchvision_frcnn,
    random_frcnn_state_dict,
)

SIZE, PRE_K, POST_K, MAX_DET = 112, 200, 64, 12


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


@pytest.fixture(scope="module")
def weights():
    sd = random_frcnn_state_dict(0)
    return sd, import_torchvision_frcnn({k: v.numpy() for k, v in sd.items()})


def _tied(sd):
    """``sd`` with a constant objectness logit a level and anchor (zero
    weights, biases 0.1, 0.1, 0.3): every top-k and the RPN's NMS choose
    among equal scores, by index."""
    sd = dict(sd)
    sd["rpn.head.cls_logits.weight"] = torch.zeros_like(
        sd["rpn.head.cls_logits.weight"])
    sd["rpn.head.cls_logits.bias"] = torch.tensor([0.1, 0.1, 0.3])
    return sd


def _collapsed(sd):
    """``_tied(sd)`` with RPN deltas of (0, 0, 4, 4): every proposal grows
    e^4-fold and clips to nearly the whole image, so that the RPN's NMS
    leaves most of its slots unfilled (zero boxes)."""
    sd = _tied(sd)
    sd["rpn.head.bbox_pred.weight"] = torch.zeros_like(
        sd["rpn.head.bbox_pred.weight"])
    sd["rpn.head.bbox_pred.bias"] = torch.tensor([0.0, 0.0, 4.0, 4.0] * 3)
    return sd


@pytest.fixture(scope="module")
def models(weights):
    """(case -> the port's model, case -> JAX variables, the JAX module
    under ``vmap``, compiled once for both weight sets)."""
    sd, variables = weights
    kw = dict(pre_nms_topk=PRE_K, post_nms_topk=POST_K,
              max_detections=MAX_DET)
    ports, jvars = {}, {}
    for name, w in (("base", sd), ("tied", _tied(sd)),
                    ("collapsed", _collapsed(sd))):
        ports[name] = pdet.FasterRCNN(device="cpu", **kw)
        ports[name].load_state_dict(w, strict=True)
        ports[name].eval()
        jvars[name] = (variables if name == "base" else
                       import_torchvision_frcnn(
                           {k: v.numpy() for k, v in w.items()}))
    jmodel = jdet.FasterRCNN(**kw)
    jrun = jax.jit(jax.vmap(jmodel.apply, in_axes=(None, 0)))
    return ports, jvars, jrun


def test_anchors_match_jax():
    for (h, w), stride, size in [((2, 3), 4, 32), ((7, 4), 32, 256),
                                 ((13, 13), 64, 512)]:
        got = pdet.make_anchors((h, w), stride, size).numpy()
        want = np.asarray(jdet.make_anchors((h, w), stride, size))
        np.testing.assert_array_equal(got, want)
        assert got.shape == (h * w * 3, 4)


def test_decode_deltas_matches_jax_and_clips():
    rng = np.random.RandomState(0)
    anchors = np.abs(rng.standard_normal((50, 4)) * 40).astype(np.float32)
    anchors[:, 2:] += anchors[:, :2] + 1
    deltas = (rng.standard_normal((50, 4)) * 3).astype(np.float32)
    deltas[:5, 2:] = [[10.0, -10.0]] * 5          # past the 4.135 clip
    got = pdet.decode_deltas(torch.tensor(anchors), torch.tensor(deltas))
    want = np.asarray(jdet.decode_deltas(jnp.asarray(anchors),
                                         jnp.asarray(deltas)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    wa = anchors[:5, 2] - anchors[:5, 0]
    np.testing.assert_allclose((got[:5, 2] - got[:5, 0]).numpy(),
                               np.exp(4.135) * wa, rtol=1e-5)


def test_fpn_levels_match_jax_at_the_octave_boundaries():
    sides = [1.0, 50.0, 111.9, 112.0, 224.0, 447.9, 448.0, 448.1, 900.0,
             2000.0]
    boxes = np.array([[10, 20, 10 + s, 20 + s] for s in sides]
                     + [[5, 5, 5, 5], [9, 9, 3, 3]], np.float32)
    got = pdet.fpn_levels(torch.tensor(boxes)).numpy()
    want = np.asarray(jdet.fpn_levels(jnp.asarray(boxes)))
    np.testing.assert_array_equal(got, want)
    assert got[sides.index(448.0)] == 3 and got[sides.index(447.9)] == 2


def test_fpn_at_112_pixels_matches_jax(weights):
    """C2..C5 at 28, 14, 7 and 4: 4 -> 7 resizes with half-pixel centres."""
    sd, variables = weights
    model = pdet.FasterRCNN(device="cpu")
    model.load_state_dict(sd)
    rng = np.random.RandomState(1)
    feats = [rng.standard_normal((2, s, s, c)).astype(np.float32)
             for s, c in zip((28, 14, 7, 4), (256, 512, 1024, 2048))]
    want = jdet.FPN().apply({"params": variables["params"]["fpn"]},
                            [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = model.backbone["fpn"](
            [torch.tensor(f).permute(0, 3, 1, 2) for f in feats])
    assert [g.shape[-1] for g in got] == [28, 14, 7, 4, 2]
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)
    # torchvision's "nearest" would read other rows at 4 -> 7.
    up = torch.nn.functional.interpolate(torch.arange(4.0)[None, None, :, None],
                                         size=(7, 1), mode="nearest-exact")
    assert up.flatten().tolist() == [0, 0, 1, 2, 2, 3, 3]


def _images(case):
    rng = np.random.RandomState(4)
    imgs = rng.randint(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    imgs[1] = np.stack([127 + 120 * np.sin(xx / (9 + c) + yy / (13 + c))
                        for c in range(3)], -1).astype(np.uint8)
    if case == "constant_half":
        imgs[:, :, SIZE // 2:] = 114
    elif case == "constant":
        imgs[0] = 114
        imgs[1] = 0
    return imgs


def _rpn(model, imgs):
    """The port's RPN logits and its proposals for a uint8 batch."""
    from imagetranslate_tpu_torch.data.images import normalize_uint8

    with torch.no_grad():
        x = normalize_uint8(torch.tensor(imgs)).permute(0, 3, 1, 2)
        rpn = model.rpn["head"](model.backbone["fpn"](
            model.backbone["body"](x)))
        return rpn, model._proposals(rpn, SIZE, SIZE)


@pytest.mark.parametrize("case", ["random", "constant_half", "constant"])
def test_faster_rcnn_matches_jax(models, case):
    ports, jvars, jrun = models
    weights = {"random": "base", "constant_half": "tied",
               "constant": "collapsed"}[case]
    model = ports[weights]
    imgs = _images(case)
    want = jrun(jvars[weights], jnp.asarray(imgs))
    with torch.no_grad():
        got = model(torch.tensor(imgs))
    assert got.boxes.shape == (2, MAX_DET, 4)
    assert got.features.shape == (2, MAX_DET, 1024)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.labels.dtype == torch.int32
    assert got.valid.sum() > 0
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=2e-3, atol=5e-2)
    np.testing.assert_allclose(got.features.numpy(),
                               np.asarray(want.features), rtol=1e-2,
                               atol=1e-2)
    feats, labels = pdet.detection_to_object_inputs(got)
    jfeats, jlabels = jax.vmap(jdet.detection_to_object_inputs)(want)
    assert feats.shape == (2, MAX_DET, 1031)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=1e-2,
                               atol=1e-2)

    # What each case is there for.
    rpn, proposals = _rpn(model, imgs)
    filled = (proposals.abs().sum(-1) > 0).sum(1)
    if case == "constant_half":
        logits = rpn[0][0][1].permute(1, 2, 0).reshape(-1)
        top = torch.sort(logits, descending=True, stable=True).values[:PRE_K]
        assert (top == top[0]).all()             # the top-k is all ties
    if case == "constant":
        assert (filled < POST_K // 2).all()      # unfilled proposal slots


def test_detector_bridge_round_trips_exactly(weights):
    sd, variables = weights
    back = DETECTOR.state_dict_from_flax(variables)
    assert set(back) == set(sd) == set(pdet.FasterRCNN(
        device="meta").state_dict())
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), k)
    got = dict(_leaves(jax.tree.map(lambda t: t.numpy(),
                                    DETECTOR.flax_from_state_dict(sd))))
    want = dict(_leaves(variables))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, k)
    drawn = dict(_leaves(jax.tree.map(lambda t: t.numpy(),
                                      DETECTOR.random_params(0))))
    for k, v in want.items():
        np.testing.assert_array_equal(drawn[k], v, k)


def test_load_torchvision_frcnn_reads_both_spellings(weights):
    sd, _ = weights
    newer = {}
    for k, v in sd.items():
        if ".fpn." in k:
            head, tail = k.rsplit(".", 1)
            k = f"{head}.0.{tail}"
        k = k.replace("rpn.head.conv.", "rpn.head.conv.0.0.")
        newer[k] = v
    newer["backbone.body.bn1.num_batches_tracked"] = torch.tensor(7)
    newer["extra_note"] = "not a tensor"
    assert "backbone.fpn.inner_blocks.2.0.weight" in newer
    assert "rpn.head.conv.0.0.bias" in newer

    class Wrapped:
        def state_dict(self):
            return newer

    for given in (newer, {"model": newer}, Wrapped(), sd):
        got = load_torchvision_frcnn(given)
        assert set(got) == set(sd)
        for k, v in sd.items():
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(), k)
    # The JAX importer reads the newer spelling to the same variables.
    jnewer = import_torchvision_frcnn(
        {k: v.numpy() for k, v in newer.items() if hasattr(v, "numpy")})
    want = dict(_leaves(jax.tree.map(lambda t: t.numpy(),
                                     DETECTOR.flax_from_state_dict(sd))))
    got = dict(_leaves(jnewer))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, k)
    with pytest.raises(KeyError, match="rpn.head.bbox_pred"):
        load_torchvision_frcnn({k: v for k, v in sd.items()
                                if not k.startswith("rpn.head.bbox")})


# ---------------- cli.caption --obj ----------------

N_IMAGES = 3     # one batch, its rows padded to 8 for the grid and detector


@pytest.fixture(scope="module")
def caption_dir(tmp_path_factory, weights):
    from PIL import Image

    from imagetranslate_tpu.models.config import tiny_config as jtiny
    from imagetranslate_tpu.text.processor import TextProcessor
    from imagetranslate_tpu.train.checkpoint import save_checkpoint
    from imagetranslate_tpu_torch.models.config import tiny_config
    from imagetranslate_tpu_torch.train.weights import CAPTION

    d = tmp_path_factory.mktemp("caption_obj")
    words = ["alpha", "beta", "gamma", "delta", "epsi", "zeta"]
    rng = np.random.RandomState(0)
    (d / "c.txt").write_text("\n".join(
        " ".join(words[j] for j in rng.randint(0, 6, rng.randint(2, 6)))
        for _ in range(100)))
    TextProcessor().train_tokenizer([str(d / "c.txt")], 150, str(d / "tok"),
                                    {"<aa>": 0, "<bb>": 1})
    tp = TextProcessor(str(d / "tok"))
    folder = d / "images"
    folder.mkdir()
    for i, (w, h) in enumerate([(320, 240), (256, 300), (200, 200)]):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        planes = [127 + 120 * np.sin(xx / (7 + c + i) + yy / (11 + 2 * c))
                  for c in range(3)]
        Image.fromarray(np.stack(planes, -1).astype(np.uint8)).save(
            folder / f"img{i}.jpg", quality=90)
    kw = dict(vocab_size=tp.vocab_size(), num_languages=2, img_size=64,
              initializer_range=0.3, use_obj=True)
    variables = CAPTION.random_params(tiny_config(**kw), 0)
    save_checkpoint(str(d / "model"), jtiny(**kw), variables)
    torch.save(weights[0], d / "frcnn.pth")
    return d


def _caption_args(d, out):
    return ["--tok", str(d / "tok"), "--model", str(d / "model"),
            "--input", str(d / "images"), "--target", "bb",
            "--output", str(out), "--batch", "8", "--max_len", "10",
            "--beam", "2", "--obj", "--fcnn", str(d / "frcnn.pth")]


def test_caption_obj_cli_matches_jax(caption_dir):
    from imagetranslate_tpu.cli.caption import main as jax_main
    from imagetranslate_tpu_torch.cli.caption import main as port_main
    d = caption_dir
    jax_main(_caption_args(d, d / "jax.tsv"))
    port_main(_caption_args(d, d / "port.tsv") + ["--device", "cpu"])
    got = (d / "port.tsv").read_text()
    assert got == (d / "jax.tsv").read_text()
    lines = got.splitlines()
    assert [os.path.basename(ln.split("\t")[0]) for ln in lines] == [
        f"img{i}.jpg" for i in range(N_IMAGES)]


def test_caption_obj_without_fcnn_stops_as_jax(caption_dir, tmp_path):
    from imagetranslate_tpu.cli.caption import main as jax_main
    from imagetranslate_tpu_torch.cli.caption import main as port_main

    args = _caption_args(caption_dir, tmp_path / "o.tsv")[:-2]
    with pytest.raises(SystemExit) as want:
        jax_main(args)
    with pytest.raises(SystemExit) as got:
        port_main(args + ["--device", "cpu"])
    assert str(got.value) == str(want.value) == (
        "--obj needs --fcnn <state_dict.pth>")
    assert not (tmp_path / "o.tsv").exists()
