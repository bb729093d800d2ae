"""Beam decode cross-attention over deduplicated encoder K/V, one query token a
row (the JAX package's ``Attention.cross_step_dedup``,
imagetranslate_tpu/models/transformer.py).

The K beams of a source attend the same encoder states, so the decode cache
keeps the encoder K/V once a source, ``k``/``v [B, S, H, D]``, and query row
``r = b * K + q`` of ``q [B * K, H, D]`` (beam q of source b) reads source b's
copy. For each row and head:

- scores ``q . k`` accumulated in fp32 from the stored dtype, times
  ``attention_scale(D)``, plus the source's fp32 ``bias [B, 1, 1, S]`` (the
  padding mask; every position is read and its bias added);
- an fp32 softmax over the S positions, the normalised probabilities rounded
  to v's dtype;
- ``p . v`` accumulated in fp32, ``ctx [B * K, H, D]`` in v's dtype.

That is the arithmetic of the plain attention (``ops/attention.py``) on K/V
repeated per beam, in the same order of roundings.

``cross_attention`` routes by what it can see, once: off the CPU with bf16 q
and K/V (``kernel_dtypes``) it launches the hand-written kernel of
``csrc/cross_attention.cu`` (one launch a call, split by ``work_plan``; see the
note there) or raises; on the CPU, and for any other dtypes (an fp32 model on
the card), it runs ``cross_attention_reference``, the same arithmetic in plain
tensor ops.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from imagetranslate_tpu_torch.ops import _build
from imagetranslate_tpu_torch.ops.attention import attention_scale

# Kernel launches, counted where the kernel is launched and nowhere else.
LAUNCHES = 0

MAX_HEAD_DIM = 128      # csrc/cross_attention.cu: MAX_D
# The kernel's work plan; the constants of csrc/cross_attention.cu.
MAX_CHANNELS = 256      # hg D a unit
MAX_UNITS = 32          # (beam tile, head, 16 channels) a unit
STAGE_BYTES = 40960     # a ring slot's lines, at most, in whole 16s
MAX_DEPTH = 4           # ring slots
HALF_SMEM = 115712      # two blocks an SM: 228 KB, 1 KB each kept
SMEM_LIMIT = 232448     # 227 KB a block


class WorkPlan(NamedTuple):
    """How the kernel splits a call: a unit is a source and ``heads`` heads,
    and resident blocks walk the units; K's and V's lines come in tiles of
    ``spos`` positions (the whole source where it has fewer) through a ring
    of ``depth`` slots that runs across units; with ``scratch`` the scores
    live in a scratch of ``scratch_bytes``, else in the block's ``smem``
    bytes of shared memory beside the ring."""
    heads: int
    spos: int
    depth: int
    scratch: bool
    smem: int


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _pitches(S: int):
    """A score row's pitch (fp32, 4 mod 32) and a p row's (bf16, 8 mod 64)
    over S positions (csrc/cross_attention.cu: score_pitch, p_pitch)."""
    sp = _pad16(S)
    return -(-(sp - 4) // 32) * 32 + 4, -(-(sp - 8) // 64) * 64 + 8


def scratch_bytes(B: int, K: int, S: int, H: int) -> int:
    """The scratch of a plan with ``scratch``: every (source, head, beam)
    row's fp32 scores and bf16 p."""
    scp, pp = _pitches(S)
    return B * H * K * (4 * scp + 2 * pp)


def work_plan(K: int, S: int, H: int, D: int) -> WorkPlan:
    """The kernel's plan for K beams a source over S positions of H heads of
    width D (``plan`` in csrc/cross_attention.cu, which refuses any other):
    the most heads a unit (a divisor of H) with at most ``MAX_CHANNELS``
    channels and ``MAX_UNITS`` units of the PV pass, with the deepest ring
    (4, 3, then 2 slots), first where two blocks fit an SM, then where one
    does; else the most heads with the scores in the scratch. Raises where
    no head count keeps the units (too many beams for the head width)."""
    nbt, dt, sp = -(-K // 8), -(-D // 16), _pad16(S)
    heads = [hg for hg in range(H, 0, -1)
             if H % hg == 0 and hg * D <= MAX_CHANNELS
             and hg * dt * nbt <= MAX_UNITS]
    if not heads:
        raise ValueError(f"no cross attention plan for {K} beams at D = {D}: "
                         f"{nbt * dt} units a head, at most "
                         f"{MAX_UNITS}")
    scp, pp = _pitches(S)
    for budget in (HALF_SMEM, SMEM_LIMIT, None):
        for hg in heads:
            pitch = hg * D * 2 + 16
            spos = max(16, STAGE_BYTES // pitch // 16 * 16)
            # Two units' bias, the scores and p, where they stay on chip.
            scores = 8 * sp + hg * K * (4 * scp + 2 * pp)
            for depth in range(MAX_DEPTH, 1, -1):
                # The ring, two units' q rows and the barriers.
                fixed = depth * min(S, spos) * pitch + 2 * K * pitch + 64
                if budget is None:
                    if fixed <= SMEM_LIMIT:
                        return WorkPlan(hg, spos, depth, True, fixed)
                elif fixed + scores <= budget:
                    return WorkPlan(hg, spos, depth, False, fixed + scores)
    raise AssertionError("unreachable")


def kernel_dtypes(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> bool:
    """The dtype half of the gate, the only half ``cross_attention`` routes
    by: bf16 q against bf16 encoder K/V. Any other pair (an fp32 model) takes
    ``cross_attention_reference`` on the card; inside these dtypes the kernel
    launches or raises."""
    return q_dtype == torch.bfloat16 and kv_dtype == torch.bfloat16


def _parts(q, k, v, bias) -> int:
    """Checks the call's shapes (any device) and returns K, the beams a
    source."""
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError(f"q must be [R, H, D] and k [B, S, H, D], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    R, H, D = q.shape
    B, S = k.shape[:2]
    if tuple(k.shape[2:]) != (H, D) or v.shape != k.shape:
        raise ValueError(f"k and v must be [B, S, {H}, {D}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if S < 1 or R < B or R % B:
        raise ValueError(f"{R} query rows are not K beams of each of {B} "
                         f"sources (S = {S})")
    if bias is not None and tuple(bias.shape) != (B, 1, 1, S):
        raise ValueError(f"bias must be [{B}, 1, 1, {S}] (one a source), got "
                         f"{tuple(bias.shape)}")
    return R // B


def cross_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain version, the kernel's arithmetic in tensor ops: the K queries of
    a source as the rows of one product against its single K/V."""
    K = _parts(q, k, v, bias)
    R, H, D = q.shape
    B, S = k.shape[:2]
    f32 = torch.float32
    qh = q.reshape(B, K, H, D).permute(0, 2, 1, 3).to(f32)   # [B, H, K, D]
    kh = k.permute(0, 2, 3, 1).to(f32)                       # [B, H, D, S]
    scores = torch.matmul(qh, kh) * attention_scale(D)
    if bias is not None:
        scores = scores + bias.to(f32)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.matmul(probs, v.permute(0, 2, 1, 3))         # [B, H, K, D]
    return ctx.permute(0, 2, 1, 3).reshape(R, H, D)


def _check_cuda_args(q, k, v, bias):
    if q.device.type != "cuda":
        raise ValueError(f"the cross attention kernel runs on a CUDA card, "
                         f"not {q.device}")
    H, D = q.shape[1:]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the cross attention kernel takes bf16 {name}, "
                            f"got {t.dtype}")
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"call outside the cross attention kernel's gate: "
                         f"D = {D}, a multiple of 8 up to {MAX_HEAD_DIM}")
    if bias is not None and bias.dtype != torch.float32:
        raise TypeError(f"the cross attention kernel takes an fp32 bias, got "
                        f"{bias.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides "
                             f"{t.stride()}")
        if t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if t is not bias and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _build.require_hopper(q.device, "the cross attention kernel is")


def _launch(q, k, v, bias, K):
    global LAUNCHES
    _check_cuda_args(q, k, v, bias)
    lib = _build.load()
    R, H, D = q.shape
    B, S = k.shape[:2]
    plan = work_plan(K, S, H, D)
    out = torch.empty_like(q)
    scratch = (torch.empty(scratch_bytes(B, K, S, H) // 4,
                           dtype=torch.float32, device=q.device)
               if plan.scratch else None)
    with torch.cuda.device(q.device):
        err = lib.itt_cross_attn_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, K, S, H, D,
            attention_scale(D), plan.heads, plan.spos, plan.depth,
            int(plan.scratch),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("cross attention launch failed: "
                           + lib.itt_error_string(err).decode())
    LAUNCHES += 1
    return out


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B * K, H, D]; k, v [B, S, H, D], once a source; bias [B, 1, 1, S]
    or None. Returns ctx [B * K, H, D] in v's dtype. No gradient.

    A CPU tensor, or dtypes other than bf16 q and K/V, runs the plain
    version; otherwise the kernel launches (a CUDA card, D a multiple of 8 up
    to 128, contiguous, within ``work_plan``) or raises."""
    K = _parts(q, k, v, bias)
    if q.device.type == "cpu" or not kernel_dtypes(q.dtype, k.dtype):
        return cross_attention_reference(q, k, v, bias)
    return _launch(q, k, v, bias, K)
