"""Faster R-CNN (ResNet-50 FPN) inference, the object stream's detector (port
of imagetranslate_tpu/models/detector.py: ``ResNet50C``, ``FPN``,
``RPNHead``, ``BoxHead``, ``make_anchors``, ``decode_deltas``,
``fpn_levels``, ``DetectionResult``, ``FasterRCNN`` and
``detection_to_object_inputs``).

    images [B, H, W, 3] (uint8, or ImageNet-normalised float32)
        -> DetectionResult of [B, max_detections, ...]

Every stage keeps the JAX module's fixed shapes and choices, so that the two
select the same boxes:

- proposals: per FPN level the ``pre_nms_topk`` best objectness logits, by a
  stable descending sort (equal logits in index order, as ``lax.top_k``
  gives them: a constant-colour region gives equal logits), decoded against
  torchvision's anchors and clipped to the image; then one NMS over all
  levels with each level's boxes shifted by ``level * (max(H, W) + 2)``, so
  that boxes of different levels never suppress each other;
- unfilled proposal slots are zero boxes, and they still go through
  RoIAlign and the box head (docs/PARITY.md §2.4 (b));
- each proposal pools from its FPN level (torchvision's LevelMapper, the eps
  outside the log2), and keeps its best foreground class (the JAX module's
  fixed-shape stand-in for torchvision's per-class NMS, docs/PARITY.md §2.4
  (a)); second-stage deltas are divided by (10, 10, 5, 5); a final NMS keeps
  ``max_detections`` slots, valid where their score is above
  ``score_thresh``.

The FPN's top-down path upsamples with ``nearest-exact``: that is what
``jax.image.resize(..., "nearest")`` computes (half-pixel centres), and it
differs from torchvision's ``nearest`` where a map is not an exact double of
the next (4 -> 7 gives rows 0,0,1,2,2,3,3, not 0,0,1,1,2,2,3). At 800 pixels
every level doubles exactly.

Module names are torchvision's (``backbone.body.*``,
``backbone.fpn.inner_blocks.i``, ``backbone.fpn.layer_blocks.i``,
``rpn.head.{conv,cls_logits,bbox_pred}``, ``roi_heads.box_head.fc6/fc7``,
``roi_heads.box_predictor.{cls_score,bbox_pred}``), so a torchvision
``fasterrcnn_resnet50_fpn`` state_dict loads after
``train.weights.load_torchvision_frcnn``; the pooled RoIs flatten in (C, H, W)
order, as torchvision's do, so fc6 takes its weight as it is. The module
runs in fp32, as the JAX one does; convolutions are cuDNN's on the card.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from imagetranslate_tpu_torch.data.images import normalize_uint8
from imagetranslate_tpu_torch.models.resnet import (
    BatchNorm2d,
    Bottleneck,
    Conv2d,
)
from imagetranslate_tpu_torch.ops.detection import multilevel_roi_align, nms

ANCHOR_SIZES = (32, 64, 128, 256, 512)       # one per FPN level P2..P6
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
NUM_CLASSES = 91
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)         # the second stage's BoxCoder


class ResNet50C(nn.Module):
    """ResNet-50 trunk returning C2..C5 (NCHW), torchvision's names."""

    def __init__(self, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.conv1 = Conv2d(3, 64, 7, 2, 3, **kw)
        self.bn1 = BatchNorm2d(64, device)
        cin = 64
        for i, blocks in enumerate((3, 4, 6, 3)):
            layer = []
            for j in range(blocks):
                layer.append(Bottleneck(cin, 64 * 2 ** i,
                                        2 if i > 0 and j == 0 else 1, **kw))
                cin = 64 * 2 ** i * 4
            setattr(self, f"layer{i + 1}", nn.ModuleList(layer))

    def forward(self, x) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for i in range(4):
            for blk in getattr(self, f"layer{i + 1}"):
                x = blk(x)
            feats.append(x)
        return feats                 # C2 (1/4) .. C5 (1/32)


class FPN(nn.Module):
    """Lateral 1x1 convolutions, the top-down sum, 3x3 output convolutions,
    and P6 = every other pixel of P5; 256 channels."""

    def __init__(self, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.inner_blocks = nn.ModuleList(
            nn.Conv2d(c, 256, 1, **kw) for c in (256, 512, 1024, 2048))
        self.layer_blocks = nn.ModuleList(
            nn.Conv2d(256, 256, 3, padding=1, **kw) for _ in range(4))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [conv(f) for conv, f in zip(self.inner_blocks, feats)]
        outs = [laterals[-1]]
        for lat in laterals[-2::-1]:
            up = F.interpolate(outs[0], size=lat.shape[-2:],
                               mode="nearest-exact")
            outs.insert(0, lat + up)
        outs = [conv(o) for conv, o in zip(self.layer_blocks, outs)]
        return outs + [F.max_pool2d(outs[-1], 1, 2, 0)]   # P2..P6


class RPNHead(nn.Module):
    """A shared 3x3 convolution, then objectness logits and box deltas for
    the three anchors of every cell, at each level."""

    def __init__(self, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        A = len(ANCHOR_RATIOS)
        self.conv = nn.Conv2d(256, 256, 3, padding=1, **kw)
        self.cls_logits = nn.Conv2d(256, A, 1, **kw)
        self.bbox_pred = nn.Conv2d(256, A * 4, 1, **kw)

    def forward(self, feats):
        out = []
        for f in feats:
            h = F.relu(self.conv(f))
            out.append((self.cls_logits(h), self.bbox_pred(h)))
        return out


class BoxHead(nn.Module):
    """TwoMLPHead + FastRCNNPredictor (``box_head.fc6/fc7``,
    ``box_predictor.cls_score/bbox_pred``); also returns the 1024-d pooled
    feature the object stream consumes."""

    def __init__(self, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.box_head = nn.ModuleDict({
            "fc6": nn.Linear(256 * 7 * 7, 1024, **kw),
            "fc7": nn.Linear(1024, 1024, **kw)})
        self.box_predictor = nn.ModuleDict({
            "cls_score": nn.Linear(1024, NUM_CLASSES, **kw),
            "bbox_pred": nn.Linear(1024, NUM_CLASSES * 4, **kw)})

    def forward(self, pooled):           # [..., C, 7, 7]
        x = pooled.flatten(-3)           # (C, H, W) order, torchvision's
        x = F.relu(self.box_head["fc6"](x))
        feats = F.relu(self.box_head["fc7"](x))
        return (self.box_predictor["cls_score"](feats),
                self.box_predictor["bbox_pred"](feats), feats)


def make_anchors(shape_hw: Tuple[int, int], stride: int, size: int,
                 device=None) -> torch.Tensor:
    """Dense [H*W*A, 4] xyxy anchors of one level, torchvision's
    AnchorGenerator: base anchors (-w/2, -h/2, w/2, h/2) rounded to integers,
    shifted by cell corners ``arange * stride``; ratio-major base anchors,
    cell-major / anchor-minor layout."""
    H, W = shape_hw
    f32 = dict(dtype=torch.float32, device=device)
    ratios = torch.tensor(ANCHOR_RATIOS, **f32)
    h_r = torch.sqrt(ratios)
    ws = size / h_r
    hs = size * h_r
    base = torch.round(torch.stack([-ws, -hs, ws, hs], -1) / 2.0)   # [A, 4]
    sx = torch.arange(W, **f32) * stride
    sy = torch.arange(H, **f32) * stride
    syg, sxg = torch.meshgrid(sy, sx, indexing="ij")
    shifts = torch.stack([sxg, syg, sxg, syg], -1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def decode_deltas(anchors: torch.Tensor, deltas: torch.Tensor,
                  clip: float = 4.135) -> torch.Tensor:
    """torchvision's BoxCoder.decode with (1, 1, 1, 1) weights, over the
    last axis of [..., 4]."""
    wa = anchors[..., 2] - anchors[..., 0]
    ha = anchors[..., 3] - anchors[..., 1]
    cxa = anchors[..., 0] + wa / 2
    cya = anchors[..., 1] + ha / 2
    dx, dy, dw, dh = deltas.unbind(-1)
    dw = torch.clamp(dw, -clip, clip)
    dh = torch.clamp(dh, -clip, clip)
    cx = dx * wa + cxa
    cy = dy * ha + cya
    w = torch.exp(dw) * wa
    h = torch.exp(dh) * ha
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _clip_boxes(boxes: torch.Tensor, H: int, W: int) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1.clamp(0, W), y1.clamp(0, H), x2.clamp(0, W),
                        y2.clamp(0, H)], -1)


def fpn_levels(boxes: torch.Tensor) -> torch.Tensor:
    """torchvision's LevelMapper (canonical 224 at level 4, k in [2, 5]):
    [..., 4] xyxy -> [...] index into P2..P5 (0-based). The eps sits outside
    the log2, as torchvision's does: a 448 x 448 box floors to the higher
    level."""
    areas = torch.clamp((boxes[..., 2] - boxes[..., 0])
                        * (boxes[..., 3] - boxes[..., 1]), min=1.0)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(areas) / 224.0) + 1e-6)
    return (torch.clamp(lvl, 2, 5) - 2).to(torch.int64)


class DetectionResult(NamedTuple):
    boxes: torch.Tensor      # [..., max_det, 4]
    labels: torch.Tensor     # [..., max_det] int32 (0 = invalid slot)
    scores: torch.Tensor     # [..., max_det]
    features: torch.Tensor   # [..., max_det, 1024] pooled box features
    valid: torch.Tensor      # [..., max_det] bool


class FasterRCNN(nn.Module):
    """Batched inference graph with the JAX module's defaults."""

    def __init__(self, pre_nms_topk: int = 1000, post_nms_topk: int = 256,
                 max_detections: int = 36, score_thresh: float = 0.05,
                 nms_thresh: float = 0.5, rpn_nms_thresh: float = 0.7,
                 device=None):
        super().__init__()
        self.pre_nms_topk = pre_nms_topk
        self.post_nms_topk = post_nms_topk
        self.max_detections = max_detections
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.rpn_nms_thresh = rpn_nms_thresh
        self.backbone = nn.ModuleDict({"body": ResNet50C(device),
                                       "fpn": FPN(device)})
        self.rpn = nn.ModuleDict({"head": RPNHead(device)})
        self.roi_heads = BoxHead(device)

    def _proposals(self, rpn_out, H: int, W: int):
        """Per-level top-k, decode and clip, then the joint NMS with the
        level offsets -> proposals [B, post_nms_topk, 4], zero where
        unfilled."""
        all_boxes, all_scores, all_lvls = [], [], []
        for lvl, ((cls, reg), size) in enumerate(zip(rpn_out, ANCHOR_SIZES)):
            B, A, h, w = cls.shape
            anchors = make_anchors((h, w), 4 * 2 ** lvl, size, cls.device)
            # (h, w, anchor) order, deltas as (anchor, 4): the JAX layout.
            scores = cls.permute(0, 2, 3, 1).reshape(B, -1)
            deltas = reg.permute(0, 2, 3, 1).reshape(B, -1, 4)
            k = min(self.pre_nms_topk, scores.shape[1])
            top_s, top_i = torch.sort(scores, dim=1, descending=True,
                                      stable=True)
            top_s, top_i = top_s[:, :k], top_i[:, :k]
            d = deltas.gather(1, top_i[..., None].expand(B, k, 4))
            boxes = _clip_boxes(decode_deltas(anchors[top_i], d), H, W)
            all_boxes.append(boxes)
            all_scores.append(top_s)
            all_lvls.append(torch.full((k,), float(lvl), device=cls.device))
        boxes = torch.cat(all_boxes, 1)
        scores = torch.cat(all_scores, 1)
        lvl_off = torch.cat(all_lvls)[:, None] * (max(H, W) + 2.0)
        keep_idx, keep_valid = nms(boxes + lvl_off, torch.sigmoid(scores),
                                   self.rpn_nms_thresh, self.post_nms_topk)
        kept = boxes.gather(1, keep_idx[..., None].expand(-1, -1, 4))
        return kept * keep_valid[..., None]

    def forward(self, images: torch.Tensor) -> DetectionResult:
        """images [B, H, W, 3]: uint8 (normalised here, on the device) or
        ImageNet-normalised float32."""
        if images.dtype == torch.uint8:
            images = normalize_uint8(images)
        B, H, W, _ = images.shape
        x = images.to(torch.float32).permute(0, 3, 1, 2)
        pyramid = self.backbone["fpn"](self.backbone["body"](x))
        proposals = self._proposals(self.rpn["head"](pyramid), H, W)

        level = fpn_levels(proposals)
        pooled = multilevel_roi_align(
            [p.permute(0, 2, 3, 1) for p in pyramid[:4]], proposals, level,
            output_size=7, sampling_ratio=2)            # [B, N, 7, 7, C]
        class_scores, class_deltas, box_feats = self.roi_heads(
            pooled.permute(0, 1, 4, 2, 3))
        probs = torch.softmax(class_scores, dim=-1)

        # The best foreground class per proposal.
        best_p, best_c0 = probs[..., 1:].max(dim=-1)
        best_c = best_c0 + 1
        N = best_c.shape[1]
        deltas = class_deltas.reshape(B, N, NUM_CLASSES, 4).gather(
            2, best_c[..., None, None].expand(B, N, 1, 4))[:, :, 0]
        weights = torch.tensor(BOX_WEIGHTS, device=deltas.device)
        final_boxes = _clip_boxes(decode_deltas(proposals, deltas / weights),
                                  H, W)
        sc = torch.where(best_p > self.score_thresh, best_p,
                         torch.zeros((), device=best_p.device))
        det_idx, det_valid = nms(final_boxes, sc, self.nms_thresh,
                                 self.max_detections)
        det_sc = sc.gather(1, det_idx)
        det_valid = det_valid & (det_sc > 0)
        labels = torch.where(det_valid, best_c.gather(1, det_idx), 0)
        return DetectionResult(
            boxes=final_boxes.gather(1, det_idx[..., None].expand(-1, -1, 4)),
            labels=labels.to(torch.int32),
            scores=det_sc * det_valid,
            features=box_feats.gather(
                1, det_idx[..., None].expand(-1, -1, box_feats.shape[-1]))
            * det_valid[..., None],
            valid=det_valid)


def detection_to_object_inputs(det: DetectionResult, image_size: int = 800):
    """DetectionResult -> (box_features [..., O, 1024 + 7], labels [..., O]):
    the pooled features and the geometry x1, x2, y1, y2, w, h, w*h over
    ``image_size``, zero on invalid slots."""
    b = det.boxes / image_size
    x1, y1, x2, y2 = b.unbind(-1)
    w = x2 - x1
    h = y2 - y1
    geom = torch.stack([x1, x2, y1, y2, w, h, w * h], -1)
    feats = torch.cat([det.features, geom], -1)
    return feats * det.valid[..., None], det.labels
