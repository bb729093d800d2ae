"""Beam decode self-attention, one query token a row (port of
imagetranslate_tpu/ops/decode_attention.py::windowed_decode_attention, whose
semantics ``reference_windowed_decode_attention`` and
``Attention.step_windowed`` of the JAX package spell out).

For query row ``r = b * K + q`` of ``q [R, H, D]`` and each head:

- prefix keys/values: positions ``0 .. t0-1`` of physical row
  ``b * K + rowsel[b, q]`` of ``main_k/main_v [R, t0, H, D]``;
- window keys/values: slot ``w`` of physical row ``b * K + wanc[b, q, w]`` of
  ``win_k/win_v [R, W, H, D]``, for the live slots ``w <= j``;
- scores ``q . k / sqrt(D)`` accumulated in fp32 from the stored dtype, an fp32
  softmax over the ``t0 + j + 1`` live positions, the normalised
  probabilities rounded to q's dtype, then ``p . v`` accumulated in fp32;
  ``ctx [R, H, D]`` in q's dtype.

The row maps are optional: without ``rowsel`` (``wanc``) the prefix (window)
of row ``r`` is row ``r`` itself. With neither map and no window this is the
decode step of the port's own cache, ``[B * K, L, H, D]`` with rows reordered
after every beam selection: ``decode_attention(q, k[:, :index + 1],
v[:, :index + 1])``. Either part may be empty, not both. ``j`` is a host int.

On a CUDA tensor ``decode_attention`` launches the hand-written kernel of
``csrc/decode_attention.cu`` (one launch a call, split by ``work_plan``; see
the note there) or raises; on a CPU tensor it runs
``decode_attention_reference``, the same arithmetic in plain tensor ops.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from imagetranslate_tpu_torch.ops import _build
from imagetranslate_tpu_torch.ops.attention import attention_scale

# Kernel launches, counted where the kernel is launched and nowhere else.
LAUNCHES = 0

MAX_HEAD_DIM = 128      # csrc/decode_attention.cu: MAX_D
# The gate's longest row. A row's scores live in shared memory while they
# fit and in an fp32 scratch beyond, so this is not a limit of the kernel's:
# it keeps the gate where it has been held on the card.
MAX_LIVE = 57344

# The kernel's work plan; the constants of csrc/decode_attention.cu.
MAX_HEADS = 12          # heads a block owns at most: a warp each
FEW_WARPS = 8           # fewer heads split a head's positions over warps
SMS = 132               # an H100's SMs
WAVE = 2 * SMS          # blocks a cluster split aims at
STAGE_BYTES = 24576     # a ring stage's lines, at most (twice that when the
                        # blocks fit the SMs once), in whole 16s, at least 16
MAX_DEPTH = 4
HALF_SMEM = 115712      # two blocks an SM: 228 KB, 1 KB each kept
MIN_RANGE = 256         # positions a block of a cluster takes at least
MAX_CLUSTER = 8
SMEM_LIMIT = 232448     # 227 KB a block


class WorkPlan(NamedTuple):
    """How the kernel splits a call: a block owns row r, head group g (of
    ``groups``, H / groups heads each) and cluster rank c (of ``clusters``);
    rank c takes the live positions [c per, min((c + 1) per, n)), ``wph``
    warps a head. Its ring holds ``depth`` stages of ``spos`` position lines
    of the group's heads.
    With ``scratch`` the scores live in an fp32 [R, H, n] scratch, else in
    the block's ``smem`` bytes of shared memory beside the ring."""
    clusters: int
    groups: int
    wph: int
    per: int
    spos: int
    depth: int
    scratch: bool
    smem: int


def work_plan(R: int, H: int, D: int, t0: int, wlive: int) -> WorkPlan:
    """The kernel's plan for R rows of H heads of width D over t0 prefix
    positions and wlive window slots (``plan`` in csrc/decode_attention.cu,
    which refuses any other). A head group is the fewest heads' split with
    at most ``MAX_HEADS`` heads; a row's positions go to 2, 4 or 8 blocks of
    a cluster while the card holds fewer than two blocks a SM and each block
    keeps ``MIN_RANGE`` positions; a stage holds at most ``STAGE_BYTES``
    (twice that when the blocks fit the SMs once) in a multiple of 16
    positions, at least 16."""
    n = t0 + wlive
    groups = next(g for g in range(1, H + 1)
                  if H % g == 0 and H // g <= MAX_HEADS)
    hg = H // groups
    wph = FEW_WARPS // hg if hg < FEW_WARPS else 1
    seg = hg * D * 2
    clusters = 1
    while (clusters < MAX_CLUSTER and R * groups * clusters < WAVE
           and n >= 2 * clusters * MIN_RANGE):
        clusters *= 2
    per = -(-n // clusters)
    # A stage holds a multiple of 16 positions (an mma's rows).
    stage_bytes = STAGE_BYTES * (1 if R * groups * clusters > SMS else 2)
    spos = max(16, min(stage_bytes // seg // 16 * 16, -(-per // 16) * 16))
    # The ring: depth stages of spos lines, a q area of seg bytes and a pair
    # of barriers each; up to MAX_DEPTH stages, fewer (at least 2) where
    # there are more blocks than SMs and two would not fit one. The scores
    # stay in shared memory if they fit beside a ring of 2 or more stages,
    # else in the scratch.
    warps = hg * wph
    others = 4 * (2 * warps + 2 * hg) + (
        4 * (warps + hg) * D if clusters > 1 or wph > 1 else 0)
    scores = 4 * hg * per
    # A block that walks rows keeps MAX_DEPTH stages (the next rows' land
    # during this one's); one that owns a cluster's share of a row needs no
    # more than its stages.
    depth = min(MAX_DEPTH, 2 * -(-per // spos)) if clusters > 1 else MAX_DEPTH
    stage = (spos + 1) * seg + 16
    while depth > 2 and depth * stage + others > SMEM_LIMIT:
        depth -= 1
    # A shallower ring (down to 2) before the scratch, whose loads and stores
    # cost more than the depth.
    shallow = depth
    while shallow > 2 and shallow * stage + others + scores > SMEM_LIMIT:
        shallow -= 1
    scratch = shallow * stage + others + scores > SMEM_LIMIT
    if not scratch:
        depth = shallow
    kept = 0 if scratch else scores
    while (R * groups * clusters > SMS and depth > 2
           and depth * stage + others + kept > HALF_SMEM):
        depth -= 1
    return WorkPlan(clusters, groups, wph, per, spos, depth, scratch,
                    depth * stage + others + kept)


def kernel_dtypes(q_dtype: torch.dtype, cache_dtype: torch.dtype) -> bool:
    """The dtype half of the gate, the only half a caller may route by: bf16
    q against a bf16 cache. An fp32 model, or an fp32 or fp8 cache, takes the
    caller's plain attention on the card. Inside these dtypes a caller calls
    ``decode_attention``, which launches the kernel or raises."""
    return q_dtype == torch.bfloat16 and cache_dtype == torch.bfloat16


def kernel_supported(q_dtype: torch.dtype, cache_dtype: torch.dtype,
                     head_dim: int, live: int) -> bool:
    """Does the CUDA kernel take a call with these dtypes, this head width
    and this many live positions? ``kernel_dtypes``, D a multiple of 8 up to
    128, 1 .. ``MAX_LIVE`` positions. A call on the card with the dtypes
    right and the shape outside raises before the launch."""
    return (kernel_dtypes(q_dtype, cache_dtype)
            and head_dim % 8 == 0 and 8 <= head_dim <= MAX_HEAD_DIM
            and 1 <= live <= MAX_LIVE)


def _parts(q, main_k, main_v, win_k, win_v, rowsel, wanc, j):
    """Checks the call's shapes (any device) and returns (t0, live window
    slots, K)."""
    if q.ndim != 3:
        raise ValueError(f"q must be [R, H, D], got {tuple(q.shape)}")
    R, H, D = q.shape
    t0 = 0 if main_k is None else main_k.shape[1]
    if (main_k is None) != (main_v is None) or (win_k is None) != (
            win_v is None):
        raise ValueError("keys and values come in pairs")
    if main_k is not None and (tuple(main_k.shape) != (R, t0, H, D)
                               or main_v.shape != main_k.shape):
        raise ValueError(f"main_k and main_v must be [{R}, t0, {H}, {D}], "
                         f"got {tuple(main_k.shape)} and "
                         f"{tuple(main_v.shape)}")
    wlive = 0
    if win_k is not None:
        if j is None:
            raise ValueError("a window needs j, its newest live slot")
        W = win_k.shape[1]
        if tuple(win_k.shape) != (R, W, H, D) or win_v.shape != win_k.shape:
            raise ValueError(f"win_k and win_v must be [{R}, W, {H}, {D}], "
                             f"got {tuple(win_k.shape)} and "
                             f"{tuple(win_v.shape)}")
        if not 0 <= int(j) < W:
            raise ValueError(f"j = {j} outside the window's {W} slots")
        wlive = int(j) + 1
    if t0 + wlive < 1:
        raise ValueError("no live position: the prefix and the window are "
                         "both empty")
    if wanc is not None and win_k is None:
        raise ValueError("wanc maps a window's slots: it needs win_k/win_v")
    K = 1
    for name, m in (("rowsel", rowsel), ("wanc", wanc)):
        if m is None:
            continue
        K = m.shape[1]
        want = (R // K, K) if name == "rowsel" else (R // K, K,
                                                     win_k.shape[1])
        if R % K or tuple(m.shape) != want:
            raise ValueError(f"{name} must be {want} for {R} rows, got "
                             f"{tuple(m.shape)}")
    if rowsel is not None and wanc is not None and (
            rowsel.shape[1] != wanc.shape[1]):
        raise ValueError("rowsel and wanc disagree on the beam width")
    return t0, wlive, K


def decode_attention_reference(q: torch.Tensor,
                               main_k: Optional[torch.Tensor] = None,
                               main_v: Optional[torch.Tensor] = None,
                               win_k: Optional[torch.Tensor] = None,
                               win_v: Optional[torch.Tensor] = None,
                               rowsel: Optional[torch.Tensor] = None,
                               wanc: Optional[torch.Tensor] = None,
                               j: Optional[int] = None) -> torch.Tensor:
    """Plain version, same signature and rounding order as the kernel: fp32
    scores from the stored dtype, normalise, round p to q's dtype, PV
    accumulated in fp32.

    The dead window slots (``w > j``) are left out. The JAX code keeps them
    and adds -10000 to their scores instead; ``exp(-10000 - m)`` is 0 in fp32
    and slot ``j`` is always live, so both give the same numbers."""
    t0, wlive, K = _parts(q, main_k, main_v, win_k, win_v, rowsel, wanc, j)
    R, H, D = q.shape
    f32 = torch.float32
    group = (torch.arange(R, device=q.device) // K) * K          # [R]
    ks, vs = [], []
    if t0 > 0:
        if rowsel is not None:
            rows = group + rowsel.reshape(R).to(torch.long)
            main_k, main_v = main_k[rows], main_v[rows]
        ks.append(main_k.to(f32))
        vs.append(main_v.to(f32))
    if wlive > 0:
        wk, wv = win_k[:, :wlive], win_v[:, :wlive]
        if wanc is not None:
            rows = group[:, None] + wanc.reshape(R, -1)[:, :wlive].to(
                torch.long)                                       # [R, wlive]
            slot = torch.arange(wlive, device=q.device)[None, :]
            wk, wv = win_k[rows, slot], win_v[rows, slot]
        ks.append(wk.to(f32))
        vs.append(wv.to(f32))
    k = torch.cat(ks, dim=1)                                      # [R, n, H, D]
    v = torch.cat(vs, dim=1)
    s = torch.einsum("rhd,rnhd->rhn", q.to(f32), k) * attention_scale(D)
    p = torch.softmax(s, dim=-1).to(q.dtype).to(f32)
    return torch.einsum("rhn,rnhd->rhd", p, v).to(q.dtype)


def _check_cuda_args(q, main_k, main_v, win_k, win_v, rowsel, wanc, live):
    H, D = q.shape[1:]
    cache = main_k if main_k is not None else win_k
    for name, t in (("q", q), ("main_k", main_k), ("main_v", main_v),
                    ("win_k", win_k), ("win_v", win_v)):
        if t is not None and t.dtype != torch.bfloat16:
            raise TypeError(f"the decode attention kernel takes bf16 {name}, "
                            f"got {t.dtype}")
    if not kernel_supported(q.dtype, cache.dtype, D, live):
        raise ValueError(f"call outside the decode attention kernel's gate: "
                         f"D = {D}, {live} live positions (see "
                         "kernel_supported)")
    if not q.is_contiguous():
        raise ValueError(f"q must be contiguous, got strides {q.stride()}")
    for name, t in (("main_k", main_k), ("main_v", main_v),
                    ("win_k", win_k), ("win_v", win_v)):
        if t is None:
            continue
        # A slice [:, :n] of a longer buffer is read in place: any row
        # stride that keeps 16-byte loads aligned, positions side by side.
        if t.stride()[1:] != (H * D, D, 1) or t.stride(0) % 8:
            raise ValueError(f"{name} must be rows of contiguous [n, H, D] "
                             f"positions, got strides {t.stride()}")
    if main_k is not None and main_k.stride(0) != main_v.stride(0):
        raise ValueError("main_k and main_v must share their row stride")
    if win_k is not None and win_k.stride(0) != win_v.stride(0):
        raise ValueError("win_k and win_v must share their row stride")
    for name, m in (("rowsel", rowsel), ("wanc", wanc)):
        if m is not None and (m.dtype != torch.int32
                              or not m.is_contiguous()):
            raise TypeError(f"{name} must be contiguous int32, got "
                            f"{m.dtype} with strides {m.stride()}")
    for name, t in (("q", q), ("main_k", main_k), ("main_v", main_v),
                    ("win_k", win_k), ("win_v", win_v), ("rowsel", rowsel),
                    ("wanc", wanc)):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _build.require_hopper(q.device, "the decode attention kernel is")


def _launch(q, main_k, main_v, win_k, win_v, rowsel, wanc, t0, wlive, K):
    global LAUNCHES
    _check_cuda_args(q, main_k, main_v, win_k, win_v, rowsel, wanc,
                     t0 + wlive)
    lib = _build.load()
    R, H, D = q.shape
    plan = work_plan(R, H, D, t0, wlive)
    out = torch.empty_like(q)
    scratch = (torch.empty((R, H, t0 + wlive), dtype=torch.float32,
                           device=q.device) if plan.scratch else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        err = lib.itt_decode_attn_bf16(
            q.data_ptr(), ptr(main_k), ptr(main_v), ptr(win_k), ptr(win_v),
            ptr(rowsel), ptr(wanc), out.data_ptr(), ptr(scratch), R, K, H, D,
            t0, wlive, 0 if win_k is None else win_k.shape[1],
            0 if main_k is None else main_k.stride(0),
            0 if win_k is None else win_k.stride(0), attention_scale(D),
            plan.clusters, plan.groups, plan.wph, plan.per, plan.spos,
            plan.depth, int(plan.scratch),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("decode attention launch failed: "
                           + lib.itt_error_string(err).decode())
    LAUNCHES += 1
    return out


def decode_attention(q: torch.Tensor,
                     main_k: Optional[torch.Tensor] = None,
                     main_v: Optional[torch.Tensor] = None,
                     win_k: Optional[torch.Tensor] = None,
                     win_v: Optional[torch.Tensor] = None,
                     rowsel: Optional[torch.Tensor] = None,
                     wanc: Optional[torch.Tensor] = None,
                     j: Optional[int] = None) -> torch.Tensor:
    """q [R, H, D]; main_k/main_v [R, t0, H, D] (the prefix, every position
    live) or None; win_k/win_v [R, W, H, D] with slots ``0 .. j`` live, or
    None; rowsel [B, K] and wanc [B, K, W] int32, or None for identity.
    Returns ctx [R, H, D] in q's dtype. No gradient.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (bf16, inside ``kernel_supported``, rows of contiguous positions) or
    raises."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError("decode_attention runs on cpu or cuda, not "
                         f"{q.device}")
    t0, wlive, K = _parts(q, main_k, main_v, win_k, win_v, rowsel, wanc, j)
    if q.device.type == "cpu":
        return decode_attention_reference(q, main_k, main_v, win_k, win_v,
                                          rowsel, wanc, j)
    if t0 == 0:
        main_k = main_v = rowsel = None
    return _launch(q, main_k, main_v, win_k, win_v, rowsel, wanc, t0, wlive,
                   K)
