"""Detection primitives of the object stream: box IoU, greedy NMS and
RoIAlign (port of imagetranslate_tpu/ops/detection.py).

The JAX module keeps every shape fixed, and so does this one, so that the
two select the same boxes:

- ``nms`` is greedy hard NMS over ``max_out`` fixed slots. Each iteration
  takes the first argmax of the scores still alive (the lowest index among
  equal scores), records it with ``valid`` True if anything was alive (else
  index 0, ``valid`` False), and drops it and every box whose IoU with it is
  above the threshold. It runs over a batch of images at once: [B, N] alive
  masks, one loop of ``max_out`` iterations for the whole batch.
- ``roi_align`` is torchvision's bilinear RoIAlign (continuous box corners,
  ``sampling_ratio`` x ``sampling_ratio`` samples per output cell, their
  mean; ``aligned`` shifts by half a pixel). A sample outside
  (-1, H) x (-1, W) counts 0; inside, its coordinates are clamped to the map.
- ``multilevel_roi_align`` pools each box from its own pyramid level only,
  by gathers from the levels' maps laid end to end, which is what the JAX
  detector's select over four full ``roi_align`` calls computes, without
  the three discarded levels' samples.

Boxes are [x1, y1, x2, y2]; feature maps are channels last, as in the JAX
module. These are plain PyTorch operations on any device: the JAX module
holds no Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] x [..., M, 4] -> [..., N, M] IoU."""
    area_a = (torch.clamp(a[..., 2] - a[..., 0], min=0)
              * torch.clamp(a[..., 3] - a[..., 1], min=0))
    area_b = (torch.clamp(b[..., 2] - b[..., 0], min=0)
              * torch.clamp(b[..., 3] - b[..., 1], min=0))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of boxes [N, 4] / scores [N], or of a batch [B, N, 4] /
    [B, N]. Returns (indices int64, valid bool), [max_out] or [B, max_out]:
    kept boxes in descending score order; an unfilled slot holds index 0
    with ``valid`` False."""
    single = scores.dim() == 1
    if single:
        boxes, scores = boxes[None], scores[None]
    B, N = scores.shape
    iou = box_iou(boxes, boxes)                       # [B, N, N]
    alive = torch.ones(B, N, dtype=torch.bool, device=scores.device)
    out_idx = torch.zeros(B, max_out, dtype=torch.int64, device=scores.device)
    out_valid = torch.zeros(B, max_out, dtype=torch.bool,
                            device=scores.device)
    neg = torch.tensor(float("-inf"), dtype=scores.dtype,
                       device=scores.device)
    for i in range(max_out):
        masked = torch.where(alive, scores, neg)
        best = masked.argmax(dim=1, keepdim=True)     # first of equal maxima
        ok = masked.gather(1, best) > neg             # [B, 1]
        out_idx[:, i:i + 1] = torch.where(ok, best, 0)
        out_valid[:, i:i + 1] = ok
        row = iou.gather(1, best[:, :, None].expand(B, 1, N))[:, 0]
        alive = alive & ~(row > iou_threshold) & ok
        alive.scatter_(1, best, False)
    if single:
        return out_idx[0], out_valid[0]
    return out_idx, out_valid


def _sample_grid(boxes: torch.Tensor, scale: torch.Tensor, output_size: int,
                 sampling_ratio: int, aligned: bool):
    """Sample coordinates of each box on its map: boxes [..., 4] in image
    coordinates, ``scale`` broadcastable to boxes[..., 0] -> (ys, xs), each
    [..., output_size * sampling_ratio], cell-major, sample-minor."""
    offset = 0.5 if aligned else 0.0
    b = boxes * scale[..., None] - offset
    x1, y1, x2, y2 = b.unbind(-1)
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:
        roi_w = torch.clamp(roi_w, min=1.0)
        roi_h = torch.clamp(roi_h, min=1.0)
    bin_w = roi_w / output_size
    bin_h = roi_h / output_size
    S = sampling_ratio
    dev = boxes.device
    cell = torch.arange(output_size, dtype=torch.float32, device=dev)
    sub = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) / S
    steps = (cell[:, None] + sub[None, :]).reshape(-1)
    ys = y1[..., None] + steps * bin_h[..., None]
    xs = x1[..., None] + steps * bin_w[..., None]
    return ys, xs


def _bilinear_flat(flat: torch.Tensor, start: torch.Tensor, H: torch.Tensor,
                   W: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
                   ) -> torch.Tensor:
    """Bilinear samples from maps laid end to end: ``flat`` [B, P, C] holds
    each image's maps row major and channels last; ``start``, ``H``, ``W``
    [B, N] say where each box's map starts and its size; ys [B, N, K], xs
    [B, N, K] -> [B, N, K, K, C] (every y against every x)."""
    Bn, P, C = flat.shape
    yy = ys[..., :, None]                               # [B, N, K, 1]
    xx = xs[..., None, :]                               # [B, N, 1, K]
    Hf = H.to(torch.float32)[..., None, None]
    Wf = W.to(torch.float32)[..., None, None]
    inside = (yy > -1.0) & (yy < Hf) & (xx > -1.0) & (xx < Wf)
    y = torch.minimum(torch.clamp(yy, min=0.0), Hf - 1)
    x = torch.minimum(torch.clamp(xx, min=0.0), Wf - 1)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    Hi = H[..., None, None]
    Wi = W[..., None, None]
    y1 = torch.minimum(y0 + 1, Hi - 1)
    x1 = torch.minimum(x0 + 1, Wi - 1)
    ly, lx = y - y0, x - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    base = (start + torch.arange(Bn, device=flat.device)[:, None] * P)[
        ..., None, None]
    table = flat.reshape(Bn * P, C)
    shape = torch.broadcast_shapes(yy.shape, xx.shape)

    def at(yi, xi):
        idx = (base + yi * Wi + xi).expand(shape).reshape(-1)
        return table.index_select(0, idx).reshape(*shape, C)

    out = (at(y0, x0) * (hy * hx)[..., None] + at(y0, x1) * (hy * lx)[..., None]
           + at(y1, x0) * (ly * hx)[..., None]
           + at(y1, x1) * (ly * lx)[..., None])
    return out * inside[..., None]


def _pool(samples: torch.Tensor, output_size: int, sampling_ratio: int):
    """[B, N, out*S, out*S, C] -> [B, N, out, out, C], the mean over each
    cell's S x S samples."""
    B, N = samples.shape[:2]
    S = sampling_ratio
    s = samples.reshape(B, N, output_size, S, output_size, S, -1)
    return s.mean(dim=(3, 5))


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              spatial_scale: float = 1.0, output_size: int = 7,
              sampling_ratio: int = 2, aligned: bool = False) -> torch.Tensor:
    """features [H, W, C]; boxes [N, 4] in input-image coordinates ->
    [N, output_size, output_size, C] (the JAX function's signature)."""
    H, W, C = features.shape
    N = boxes.shape[0]
    dev = features.device
    scale = torch.full((1, N), spatial_scale, dtype=torch.float32, device=dev)
    ys, xs = _sample_grid(boxes[None].to(torch.float32), scale, output_size,
                          sampling_ratio, aligned)
    zeros = torch.zeros(1, N, dtype=torch.int64, device=dev)
    samples = _bilinear_flat(features.reshape(1, H * W, C), zeros, zeros + H,
                             zeros + W, ys, xs)
    return _pool(samples, output_size, sampling_ratio)[0]


def multilevel_roi_align(levels: Sequence[torch.Tensor], boxes: torch.Tensor,
                         level: torch.Tensor, output_size: int = 7,
                         sampling_ratio: int = 2, aligned: bool = False
                         ) -> torch.Tensor:
    """RoIAlign of each box from its own level: ``levels`` [B, H_l, W_l, C]
    channels last, level l at stride 4 * 2^l; boxes [B, N, 4]; ``level``
    [B, N] int in [0, len(levels)) -> [B, N, out, out, C]. Equal to
    ``roi_align`` on the box's level with ``spatial_scale = 1 / (4 * 2^l)``,
    box by box."""
    B, N = level.shape
    dev = boxes.device
    sizes = [lv.shape[1:3] for lv in levels]
    flat = torch.cat([lv.reshape(B, -1, lv.shape[-1]) for lv in levels], 1)
    starts, s = [], 0
    for h, w in sizes:
        starts.append(s)
        s += h * w

    def per_level(values, dtype):
        return torch.tensor(values, dtype=dtype, device=dev)[level]

    scale = per_level([1.0 / (4 * 2 ** i) for i in range(len(levels))],
                      torch.float32)
    H = per_level([h for h, _ in sizes], torch.int64)
    W = per_level([w for _, w in sizes], torch.int64)
    start = per_level(starts, torch.int64)
    ys, xs = _sample_grid(boxes.to(torch.float32), scale, output_size,
                          sampling_ratio, aligned)
    samples = _bilinear_flat(flat, start, H, W, ys, xs)
    return _pool(samples, output_size, sampling_ratio)
