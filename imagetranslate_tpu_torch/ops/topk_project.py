"""Fused vocab projection + exact top-k + logsumexp (port of
imagetranslate_tpu/ops/topk_project.py::project_topk, K2, and
``sharded_project_topk``, K2b, its vocab-sharded form for the
tensor-parallel decode).

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

# Kernel launches, counted where the kernel is launched and nowhere else:
# K2's, and K2b's merge.
LAUNCHES = 0
MERGE_LAUNCHES = 0

MAX_K = 16
ROW_TILE = 128   # rows a block of the kernel's first pass (BM)
SMS = 132        # an H100's SMs: the plan fills them about once
MAX_SHARDS = 256  # the merge's ranges: two a thread of its 128


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


# ---------------- K2b: the vocab-sharded projection ----------------

def merge_shard_topk_reference(vals: torch.Tensor, idxs: torch.Tensor,
                               lses: torch.Tensor, k: int):
    """Plain version of the merge: the n shards' candidates concatenated
    shard-major, a stable top-k (the JAX ``lax.top_k`` over the same
    concatenation: on equal values the lower position, so the lower vocab
    index, wins), and the logsumexp of the shard lses. vals, idxs [n, M, k],
    lses [n, M] -> (val [M, k] fp32, idx [M, k] int32, lse [M] fp32)."""
    n, m, kk = vals.shape
    cand_v = vals.permute(1, 0, 2).reshape(m, n * kk)
    cand_i = idxs.permute(1, 0, 2).reshape(m, n * kk)
    val, pos = stable_topk(cand_v, k)
    idx = torch.gather(cand_i, 1, pos)
    return val, idx.to(torch.int32), torch.logsumexp(lses, dim=0)


def merge_shard_topk(vals: torch.Tensor, idxs: torch.Tensor,
                     lses: torch.Tensor, k: int):
    """The merge of K2b. A CPU tensor runs the plain version; a CUDA tensor
    launches ``itt_topk_merge`` (csrc/topk_project.cu: K2's second pass
    over the shards as its ranges, reading the gathered [n, M, k] layout in
    place) or raises."""
    global MERGE_LAUNCHES
    if vals.device.type == "cpu":
        return merge_shard_topk_reference(vals, idxs, lses, k)
    n, m, kk = vals.shape
    if kk != k or not 1 <= k <= MAX_K:
        raise ValueError(f"the merge takes lists of k (1 <= k <= {MAX_K}), "
                         f"got {kk} for k={k}")
    if n > MAX_SHARDS or idxs.shape != vals.shape or lses.shape != (n, m):
        raise ValueError(f"merge shapes: vals {tuple(vals.shape)}, idxs "
                         f"{tuple(idxs.shape)}, lses {tuple(lses.shape)}")
    for name, t, dt in (("vals", vals, torch.float32),
                        ("idxs", idxs, torch.int32),
                        ("lses", lses, torch.float32)):
        if t.device != vals.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on "
                             f"{vals.device}")
    _build.require_hopper(vals.device, "the top-k merge kernel is")
    lib = _build.load()
    val = torch.empty((m, k), dtype=torch.float32, device=vals.device)
    idx = torch.empty((m, k), dtype=torch.int32, device=vals.device)
    lse = torch.empty((m,), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.itt_topk_merge(vals.data_ptr(), idxs.data_ptr(),
                                 lses.data_ptr(), val.data_ptr(),
                                 idx.data_ptr(), lse.data_ptr(), m, n, k,
                                 stream)
    if err != 0:
        raise RuntimeError("top-k merge kernel launch failed: "
                           + lib.itt_error_string(err).decode())
    MERGE_LAUNCHES += 1
    return val, idx, lse


def sharded_project_topk(h: torch.Tensor, w_local: torch.Tensor,
                         b_local: Optional[torch.Tensor], k: int, group,
                         plain: bool = False):
    """K2b: ``project_topk`` over a vocab shard, merged over the model
    group. h [M, E] (the same rows on every rank of the group), w_local
    [V/n, E] and b_local [V/n] this rank's rows of the projection (rank i of
    the group holds vocab [i V/n, (i + 1) V/n)). Runs K2 on the shard,
    shifts its indices to global ones, gathers the n triples and merges
    them: every rank returns the same (val [M, k], idx [M, k] int32, lse
    [M]) as ``project_topk`` over the whole vocab, ties on the lowest index.
    ``plain``: the plain versions of both halves (fp32 weights, k > 16)."""
    from imagetranslate_tpu_torch.parallel.comm import (
        all_gather_stack,
        group_rank,
    )

    if plain:
        val, idx, lse = project_topk_reference(h, w_local, b_local, k)
    else:
        val, idx, lse = project_topk(h, w_local, b_local, k)
    idx = idx + group_rank(group) * w_local.shape[0]
    vals = all_gather_stack(val, group)
    idxs = all_gather_stack(idx, group)
    lses = all_gather_stack(lse, group)
    merge = merge_shard_topk_reference if plain else merge_shard_topk
    return merge(vals, idxs, lses, k)
