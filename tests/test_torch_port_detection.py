"""The port's detection primitives and ``cli.extract_objects`` against the JAX
package's (imagetranslate_tpu/ops/detection.py, cli/extract_objects.py), on
the CPU in fp32.

- ``box_iou`` on overlapping, nested, disjoint and degenerate boxes;
- ``nms``: the same kept indices and ``valid`` slots, with equal scores (the
  first index wins), slots past the last live box (index 0, invalid), boxes
  of two FPN levels kept apart by the level offset, and a batch equal to its
  images one by one;
- ``roi_align`` with ``aligned`` both ways, boxes past every edge, zero and
  sub-pixel boxes, and ``multilevel_roi_align`` against the JAX detector's
  select over four ``roi_align`` calls;
- ``cli.extract_objects`` of both packages over two JPEGs at 800 pixels with
  one random torchvision state_dict: the same keys, labels equal, features
  within the detector's tolerances, and ``ObjectStore`` reading the file.
Tolerances: IoU 1e-6; RoIAlign 1e-4 on unit-normal maps (a sample's
coordinate of up to ~100 pixels carries fp32 rounding, which XLA's fused
multiply-adds place differently, times the map's slope between pixels); the
detector's those of tests/test_detector_e2e.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.ops import detection as jdet
from imagetranslate_tpu_torch.ops import detection as pdet


def _boxes(rng, n, extent=50.0, lo=2.0, hi=20.0):
    centres = rng.rand(n, 2) * extent
    sizes = rng.rand(n, 2) * (hi - lo) + lo
    return np.concatenate([centres - sizes / 2, centres + sizes / 2],
                          1).astype(np.float32)


def test_box_iou_matches_jax():
    rng = np.random.RandomState(0)
    a = np.concatenate([_boxes(rng, 30), np.array(
        [[0, 0, 10, 10], [2, 2, 4, 4], [20, 20, 20, 30], [5, 5, 3, 3],
         [0, 0, 0, 0]], np.float32)])
    b = np.concatenate([_boxes(rng, 20), a[-5:]])
    got = pdet.box_iou(torch.tensor(a), torch.tensor(b)).numpy()
    want = np.asarray(jdet.box_iou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # Batched: one IoU matrix per image.
    two = pdet.box_iou(torch.tensor(np.stack([a, a[::-1].copy()])),
                       torch.tensor(np.stack([b, b])))
    np.testing.assert_array_equal(two[0].numpy(), got)


def _jax_nms(boxes, scores, thr, max_out):
    idx, valid = jdet.nms(jnp.asarray(boxes), jnp.asarray(scores), thr,
                          max_out=max_out)
    return np.asarray(idx), np.asarray(valid)


def _nms_cases():
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, 60)
    cases = {"random": (boxes, rng.rand(60).astype(np.float32), 0.5, 60)}
    # Ties: scores from five values, duplicated boxes among them.
    tied = boxes.copy()
    tied[10:20] = tied[0]
    cases["ties"] = (tied, (rng.randint(0, 5, 60) / 4).astype(np.float32),
                     0.5, 60)
    # More slots than survivors: the tail is index 0, invalid.
    crowd = np.tile(np.array([[0, 0, 10, 10]], np.float32), (12, 1))
    crowd[:, 2:] += rng.rand(12, 2).astype(np.float32)
    cases["all_suppressed"] = (crowd, rng.rand(12).astype(np.float32), 0.3,
                               20)
    # Zero-area boxes have IoU 0 with everything: only the pick drops them.
    cases["degenerate"] = (np.zeros((6, 4), np.float32),
                           np.array([0.5, 0.9, 0.5, 0.0, 0.9, 0.1],
                                    np.float32), 0.5, 8)
    # Two FPN levels: the same boxes at both, apart by the level offset.
    lvl_boxes = np.concatenate([boxes[:20], boxes[:20]])
    off = np.repeat(np.arange(2, dtype=np.float32), 20)[:, None] * (50 + 2.0)
    cases["level_offset"] = (lvl_boxes + off, rng.rand(40).astype(np.float32),
                             0.7, 40)
    return cases


@pytest.mark.parametrize("case", sorted(_nms_cases()))
def test_nms_matches_jax(case):
    boxes, scores, thr, max_out = _nms_cases()[case]
    idx, valid = pdet.nms(torch.tensor(boxes), torch.tensor(scores), thr,
                          max_out=max_out)
    jidx, jvalid = _jax_nms(boxes, scores, thr, max_out)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    assert idx.dtype == torch.int64 and valid.dtype == torch.bool
    if case == "all_suppressed":
        assert 0 < valid.sum() < 12 and not valid[-1]
        assert (idx[~valid] == 0).all()
    if case == "level_offset":
        kept = idx[valid].numpy()
        # Each level keeps its own boxes: no box suppressed one of the
        # other level.
        lo, hi = kept[kept < 20], kept[kept >= 20] - 20
        solo = _jax_nms(boxes[:20], scores[:20], thr, 20)
        solo2 = _jax_nms(boxes[20:], scores[20:], thr, 20)
        assert sorted(lo) == sorted(solo[0][solo[1]])
        assert sorted(hi) == sorted(solo2[0][solo2[1]])


def test_nms_batch_equals_images_one_by_one():
    cases = _nms_cases()
    (b1, s1, _, _), (b2, s2, _, _) = cases["random"], cases["ties"]
    idx, valid = pdet.nms(torch.tensor(np.stack([b1, b2])),
                          torch.tensor(np.stack([s1, s2])), 0.5, max_out=30)
    for i, (b, s) in enumerate(((b1, s1), (b2, s2))):
        jidx, jvalid = _jax_nms(b, s, 0.5, 30)
        np.testing.assert_array_equal(idx[i].numpy(), jidx)
        np.testing.assert_array_equal(valid[i].numpy(), jvalid)


def _roi_boxes(rng, H, W):
    inside = _boxes(rng, 10, extent=min(H, W) * 4, lo=4, hi=60)
    edges = np.array([
        [-30, -30, 10, 10], [W * 4 - 10, H * 4 - 10, W * 4 + 50, H * 4 + 50],
        [-80, 5, -20, 40], [5, H * 4 + 4, 30, H * 4 + 90],   # wholly outside
        [0, 0, 0, 0], [3, 3, 3.5, 3.2], [10, 10, 8, 8]], np.float32)
    return np.concatenate([inside, edges])


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("scale,sampling", [(0.25, 2), (0.125, 3), (1.0, 1)])
def test_roi_align_matches_jax(aligned, scale, sampling):
    rng = np.random.RandomState(2)
    H, W, C = 13, 17, 5
    feats = rng.standard_normal((H, W, C)).astype(np.float32)
    boxes = _roi_boxes(rng, H, W)
    got = pdet.roi_align(torch.tensor(feats), torch.tensor(boxes), scale, 7,
                         sampling, aligned).numpy()
    want = np.asarray(jdet.roi_align(jnp.asarray(feats), jnp.asarray(boxes),
                                     spatial_scale=scale, output_size=7,
                                     sampling_ratio=sampling,
                                     aligned=aligned))
    assert got.shape == want.shape == (len(boxes), 7, 7, C)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    if scale >= 0.25:
        assert not got[-5:-3].any()               # wholly outside: zero


def test_multilevel_roi_align_is_the_jax_select():
    """Each box pools from its own level only: the JAX detector's select
    over four full ``roi_align`` calls (models/detector.py:226-234)."""
    rng = np.random.RandomState(3)
    B, C = 2, 6
    shapes = [(28, 20), (14, 10), (7, 5), (4, 3)]
    levels = [rng.standard_normal((B, h, w, C)).astype(np.float32)
              for h, w in shapes]
    boxes = np.stack([_roi_boxes(rng, 28, 20) for _ in range(B)])
    level = rng.randint(0, 4, boxes.shape[:2])
    got = pdet.multilevel_roi_align([torch.tensor(lv) for lv in levels],
                                    torch.tensor(boxes),
                                    torch.tensor(level)).numpy()
    for b in range(B):
        per_level = [np.asarray(jdet.roi_align(
            jnp.asarray(levels[i][b]), jnp.asarray(boxes[b]),
            spatial_scale=1.0 / (4 * 2 ** i), output_size=7,
            sampling_ratio=2)) for i in range(4)]
        want = np.select([level[b][:, None, None, None] == i
                          for i in range(4)], per_level)
        np.testing.assert_allclose(got[b], want, atol=1e-4, rtol=1e-4)


# ---------------- cli.extract_objects ----------------

@pytest.fixture(scope="module")
def detector_files(tmp_path_factory):
    """Two smooth JPEGs of other sizes than 800, and a random torchvision
    ``fasterrcnn_resnet50_fpn`` state_dict saved as ``.pth``."""
    from PIL import Image

    from imagetranslate_tpu_torch.train.weights import random_frcnn_state_dict

    d = tmp_path_factory.mktemp("extract")
    folder = d / "images"
    folder.mkdir()
    for i, (w, h) in enumerate([(640, 480), (500, 700)]):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        planes = [127 + 120 * np.sin(xx / (23 + 5 * c + i) + yy / (31 + c))
                  for c in range(3)]
        Image.fromarray(np.stack(planes, -1).astype(np.uint8)).save(
            folder / f"img{i}.jpg", quality=90)
    (folder / "notes.txt").write_text("not an image")
    torch.save(random_frcnn_state_dict(0), d / "frcnn.pth")
    return d


def test_extract_objects_cli_matches_jax(detector_files):
    from imagetranslate_tpu.cli import extract_objects as jcli
    from imagetranslate_tpu_torch.cli import extract_objects as pcli
    from imagetranslate_tpu_torch.data.images import ObjectStore
    d = detector_files
    args = ["--input", str(d / "images"), "--fcnn", str(d / "frcnn.pth"),
            "--batch", "2"]
    jcli.main(args + ["--output", str(d / "jax.npz")])
    pcli.main(args + ["--output", str(d / "port.npz"), "--device", "cpu"])
    want, got = np.load(d / "jax.npz"), np.load(d / "port.npz")
    paths = [os.path.join(str(d / "images"), f"img{i}.jpg") for i in (0, 1)]
    assert sorted(got.files) == sorted(want.files) == sorted(
        f"{p}||{k}" for p in paths for k in ("feat", "lab"))
    for p in paths:
        feat, lab = got[f"{p}||feat"], got[f"{p}||lab"]
        assert feat.dtype == np.float32 and feat.shape == (36, 1031)
        assert lab.dtype == np.int32 and lab.shape == (36,)
        np.testing.assert_array_equal(lab, want[f"{p}||lab"])
        assert (lab > 0).sum() > 0
        np.testing.assert_allclose(feat[:, :1024], want[f"{p}||feat"][:, :1024],
                                   rtol=1e-2, atol=1e-2)
        # the geometry: boxes / 800
        np.testing.assert_allclose(feat[:, 1024:], want[f"{p}||feat"][:, 1024:],
                                   rtol=2e-3, atol=5e-2 / 800)
    store = ObjectStore(str(d / "port.npz"))
    feats, labels = store.lookup(paths + ["missing.jpg"], 4)
    assert store.n_obj == 36 and store.feat_dim == 1031
    np.testing.assert_array_equal(labels[1], got[f"{paths[1]}||lab"])
    assert not feats[2:].any() and not labels[2:].any()
