"""Deterministic flash attention (port of
imagetranslate_tpu/ops/flash_attention.py::flash_attention and of the
``custom_vjp`` around it in imagetranslate_tpu/ops/attention.py).

``softmax(q k^T * scale + bias) v`` without dropout, computed with the online
softmax over tiles of keys so that the [T, S] scores are never stored. On a
CUDA tensor ``flash_attention`` launches the hand-written kernel of
``csrc/flash_attention.cu``; on a CPU tensor it runs
``flash_attention_reference``, the same arithmetic in plain tensor ops.

Numerics contract (that of the JAX kernel): q is scaled in fp32 and rounded to
k's dtype; scores accumulate in fp32 and take the fp32 bias; the running
maximum starts at -1e30; ``p = exp(s - m)`` is cast to v's dtype
un-normalised before the product with v; the fp32 accumulator is divided by
the denominator last and cast to q's dtype. (The kernel takes exp(s - m) as
the card's fast 2^(s log2(e) - m log2(e)), one FFMA and one ex2.approx; its
~2^-22 relative error vanishes in p's rounding to bf16, and the rounding of
m log2(e) is the same in p and in the rescale factor, so it cancels.) The
plain attention of
``ops/attention.py`` normalises first and casts then, so the two agree to the
rounding of the working dtype, not to the bit.

The gradient is that of the plain attention, recomputed in the backward (the
JAX package has no backward kernel either); the bias gets none.
"""

from __future__ import annotations

from typing import Optional

import torch

from imagetranslate_tpu_torch.ops import _build
from imagetranslate_tpu_torch.ops.attention import (
    attention_scale,
    plain_attention,
)

# Kernel launches, counted where the kernel is launched and nowhere else.
LAUNCHES = 0

BLOCK_K = 128              # keys a tile (csrc/flash_attention.cu: TK)
KERNEL_HEAD_DIMS = (32, 64, 128)


def flash_supported(q: torch.Tensor, k: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> bool:
    """Does ``flash_attention`` take this call? The rules of the function:
    bias None or [B, 1, 1, S] (a bias with a query or a head extent is
    refused), T >= 8, S >= 8, D a multiple of 8. T and S need not divide by
    anything: ragged tiles are masked. On a CUDA tensor also the kernel's
    rules: bf16 q and k, D in {32, 64, 128}, B and H at most 65535; fp32 on
    the card fails the gate and takes the plain attention. A CPU tensor of
    any float dtype passes (it runs the plain version)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    if bias is not None and (bias.ndim != 4 or bias.shape[0] != B
                             or bias.shape[1] != 1 or bias.shape[2] != 1
                             or bias.shape[3] != S):
        return False
    if D % 8 != 0 or T < 8 or S < 8:
        return False
    if q.device.type == "cuda":
        if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16:
            return False
        if D not in KERNEL_HEAD_DIMS or B > 65535 or H > 65535:
            return False
    return True


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain version: the kernel's arithmetic, tile by tile (``BLOCK_K`` keys
    each), in tensor ops. q [B, T, H, D]; k, v [B, S, H, D]; bias None or
    [B, 1, 1, S]. Returns [B, T, H, D] in q's dtype."""
    B, T, H, D = q.shape
    S = k.shape[1]
    f32 = torch.float32
    qs = (q.to(f32) * attention_scale(D)).to(k.dtype).to(f32)
    qs = qs.permute(0, 2, 1, 3)                               # [B, H, T, D]
    m = torch.full((B, H, T, 1), -1e30, dtype=f32, device=q.device)
    l = torch.zeros((B, H, T, 1), dtype=f32, device=q.device)
    acc = torch.zeros((B, H, T, D), dtype=f32, device=q.device)
    for s0 in range(0, S, BLOCK_K):
        kt = k[:, s0:s0 + BLOCK_K].permute(0, 2, 3, 1).to(f32)  # [B, H, D, s]
        vt = v[:, s0:s0 + BLOCK_K].permute(0, 2, 1, 3).to(f32)  # [B, H, s, D]
        s = torch.matmul(qs, kt)
        if bias is not None:
            s = s + bias[:, :, :, s0:s0 + BLOCK_K].to(f32)
        m_cur = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).to(f32), vt)
        m = m_cur
    return (acc / l).to(q.dtype).permute(0, 2, 1, 3)


def _check_cuda_args(q, k, v, bias):
    B, T, H, D = q.shape
    S = k.shape[1]
    if k.shape != (B, S, H, D) or v.shape != k.shape:
        raise ValueError(f"k and v must be [{B}, S, {H}, {D}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the flash attention kernel takes bf16 {name}, "
                            f"got {t.dtype}")
    if bias is not None and bias.dtype != torch.float32:
        raise TypeError(f"the flash attention kernel takes an fp32 bias, "
                        f"got {bias.dtype}")
    if not flash_supported(q, k, bias):
        raise ValueError(
            f"call outside the flash attention kernel's gate: q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, bias "
            f"{None if bias is None else tuple(bias.shape)} (see "
            "flash_supported)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides "
                             f"{t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if bias is not None:
        if bias.device != q.device:
            raise ValueError(f"bias must be on {q.device}, got {bias.device}")
        # A [B, 1, 1, S] view is read in place: any batch stride, but the
        # keys of a row must lie side by side.
        if bias.stride(3) != 1 or bias.data_ptr() % 4:
            raise ValueError("bias must have unit stride along S, got "
                             f"strides {bias.stride()}")
    _build.require_hopper(q.device, "the flash attention kernel is")


def _launch(q, k, v, bias):
    global LAUNCHES
    _check_cuda_args(q, k, v, bias)
    lib = _build.load()
    B, T, H, D = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.itt_flash_attn_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            B, T, k.shape[1], H, D,
            0 if bias is None else bias.stride(0), attention_scale(D),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash attention launch failed: "
                           + lib.itt_error_string(err).decode())
    LAUNCHES += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (the plain version for a CPU tensor). Backward:
    the gradient of the plain attention, recomputed from the saved inputs;
    none for the bias."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v)
        ctx.bias = bias
        if q.device.type == "cpu":
            return flash_attention_reference(q, k, v, bias)
        return _launch(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = plain_attention(q, k, v, ctx.bias)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, T, H, D]; k, v [B, S, H, D]; bias None or additive fp32
    [B, 1, 1, S]. Returns [B, T, H, D] in q's dtype.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (bf16 q/k/v, contiguous, inside ``flash_supported``) or raises."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError("flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if q.device.type == "cpu" and not flash_supported(q, k, bias):
        raise ValueError("call outside flash_supported: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    return _FlashAttention.apply(q, k, v, bias)
