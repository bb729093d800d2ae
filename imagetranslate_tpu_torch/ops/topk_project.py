"""Fused vocab projection + exact top-k + logsumexp (port of
imagetranslate_tpu/ops/topk_project.py::project_topk).

Every beam-decode step selects its candidates from ``logits = h @ W^T + b``:
the top-k values and vocab indices per row and the row's logsumexp. On a
CUDA tensor ``project_topk`` launches the hand-written kernel in
``csrc/topk_project.cu`` (a TMA + wgmma pass over vocab ranges, then a merge
of the ranges; see the note there), which never writes the [M, V] logits to
device memory. On a CPU tensor it runs
``project_topk_reference``, the plain PyTorch version of the same function.

Numerics contract (that of the JAX kernel): fp32 accumulation over E, the
bias added in fp32, and ties broken on the LOWEST vocab index, the
``lax.top_k`` rule that the beam's reference tie semantics depend on.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from imagetranslate_tpu_torch.ops import _build

# Kernel launches, counted where the kernel is launched and nowhere else.
LAUNCHES = 0

MAX_K = 16
ROW_TILE = 128   # rows a block of the kernel's first pass (BM)
SMS = 132        # an H100's SMs: the plan fills them about once


class WorkPlan(NamedTuple):
    """How the kernel splits [M, V]: vocab tiles of ``cols`` columns, grouped
    in ``ranges`` contiguous ranges of ``per`` tiles (the last may hold
    fewer); range r covers columns [r per cols, min((r + 1) per cols, V)).
    A block owns (row tile, range), so the scratch holds ``ranges`` partial
    top-k lists and (max, sum exp) pairs per row."""
    cols: int
    per: int
    ranges: int


def work_plan(m: int, v: int, k: int) -> WorkPlan:
    """The kernel's plan for M rows, V columns and top-k (``plan`` in
    csrc/topk_project.cu, which refuses any other). Row tiles x ranges is
    about one block per SM; each range holds at least one column < V."""
    cols = 256 if k <= 4 else 128
    tiles = -(-v // cols)
    row_tiles = -(-m // ROW_TILE)
    want = min(max(SMS // row_tiles, 1), tiles)
    per = -(-tiles // want)
    return WorkPlan(cols, per, -(-tiles // per))


def scratch(m: int, k: int, plan: WorkPlan, device):
    """The first pass's output, read by the merge: per row and range the
    range's top-k values [M, R, k] and indices [M, R, k], and its (max,
    sum exp) [M, R, 2]."""
    r = plan.ranges
    return (torch.empty((m, r, k), dtype=torch.float32, device=device),
            torch.empty((m, r, k), dtype=torch.int32, device=device),
            torch.empty((m, r, 2), dtype=torch.float32, device=device))


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest values in descending
    order, equal values ordered by ascending index. ``torch.topk`` leaves the
    order among ties unspecified, so this sorts stably instead."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def project_topk_reference(h: torch.Tensor, w: torch.Tensor,
                           b: Optional[torch.Tensor], k: int):
    """Plain version: fp32 matmul + fp32 bias, logsumexp, stable top-k.
    h [M, E], w [V, E], b [V] or None -> (val [M, k] fp32, idx [M, k] int32,
    lse [M] fp32)."""
    logits = h.to(torch.float32) @ w.to(torch.float32).T
    if b is not None:
        logits = logits + b.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    val, idx = stable_topk(logits, k)
    return val, idx.to(torch.int32), lse


def _check_cuda_args(h, w, b, k):
    m, e = h.shape
    v = w.shape[0]
    if not (1 <= k <= MAX_K):
        raise ValueError(f"project_topk kernel takes 1 <= k <= {MAX_K}, "
                         f"got k={k}")
    if v < k:
        raise ValueError(f"k={k} exceeds the vocab size {v}")
    if w.ndim != 2 or w.shape[1] != e:
        raise ValueError(f"w must be [V, {e}], got {tuple(w.shape)}")
    if b.shape != (v,):
        raise ValueError(f"bias must be [{v}], got {tuple(b.shape)}")
    for name, t in (("h", h), ("w", w), ("b", b)):
        if t.device != h.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be on {h.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError("project_topk kernel takes bf16 h and w, got "
                        f"{h.dtype} and {w.dtype}")
    if b.dtype != torch.float32:
        raise TypeError(f"project_topk kernel takes an fp32 bias, got "
                        f"{b.dtype}")
    if e % 8:
        raise ValueError(f"project_topk kernel needs E % 8 == 0, got E={e}")
    _build.require_hopper(h.device, "project_topk kernel is")


def _launch(h, w, b, k):
    global LAUNCHES
    lib = _build.load()
    m, v = h.shape[0], w.shape[0]
    plan = work_plan(m, v, k)
    dev = h.device
    part_val, part_idx, part_ms = scratch(m, k, plan, dev)
    val = torch.empty((m, k), dtype=torch.float32, device=dev)
    idx = torch.empty((m, k), dtype=torch.int32, device=dev)
    lse = torch.empty((m,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.itt_project_topk_bf16(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), part_val.data_ptr(),
            part_idx.data_ptr(), part_ms.data_ptr(), val.data_ptr(),
            idx.data_ptr(), lse.data_ptr(), m, h.shape[1], v, k, plan.cols,
            plan.per, plan.ranges, stream)
    if err != 0:
        raise RuntimeError("project_topk kernel launch failed: "
                           + lib.itt_error_string(err).decode())
    LAUNCHES += 1
    return val, idx, lse


def project_topk(h: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``top_k(h @ w^T + b, k)`` and ``logsumexp(h @ w^T + b)`` per row.

    h [M, E], w [V, E] (a Linear weight or the tied embedding table),
    b [V] or None. Returns (val [M, k] fp32, idx [M, k] int32, lse [M] fp32).
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (bf16 h and w, fp32 b, contiguous, 1 <= k <= 16, sm_90) or raises.
    """
    if h.device.type == "cpu":
        return project_topk_reference(h, w, b, k)
    if h.device.type != "cuda":
        raise ValueError(f"project_topk runs on cpu or cuda, not {h.device}")
    if b is None:
        b = torch.zeros((w.shape[0],), dtype=torch.float32, device=h.device)
    _check_cuda_args(h, w, b, k)
    return _launch(h, w, b, k)
