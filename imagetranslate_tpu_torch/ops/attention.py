"""Scaled dot-product attention (port of imagetranslate_tpu/ops/attention.py):
scores = QK^T/sqrt(d) + additive bias (-10000 at masked positions), softmax in
fp32, dropout on the fp32 probs, probs cast to the V dtype, then PV.

Dispatch, as in the JAX module: a deterministic call (no dropout) over
S >= 1024 keys with ``use_pallas`` goes through the flash-attention kernel of
``ops/flash_attention.py`` when its gate passes (bias None or [B, 1, 1, S],
T >= 8; on the card bf16 and D in {32, 64, 128}); with dropout on and
``use_fused_dropout`` the call goes through the fused kernel of
``ops/train_attention.py`` when the shape gate passes; every other call takes
the plain path below. Under a mesh each rank calls this on its own rows and
heads (the JAX module's shard_map over batch and heads), with the dropout
seed shifted by the linear shard index (``DropoutRng.attention_seed``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -10000.0  # reference's additive mask value


def make_attention_bias(mask: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, ..., S] boolean keep-mask -> additive bias with -10000 at masked."""
    return ((1.0 - mask.to(torch.float32)) * NEG_INF).to(dtype)


def attention_scale(depth: int) -> float:
    """1/sqrt(depth) rounded as the JAX code computes it (fp32 sqrt, fp32
    divide), so both packages scale scores by the same fp32 number."""
    return float(np.float32(1.0) / np.sqrt(np.float32(depth)))


def plain_attention(q, k, v, bias=None, dropout_rate: float = 0.0,
                    seed: Optional[int] = None) -> torch.Tensor:
    """The plain path: fp32 scores and softmax, dropout (when
    ``dropout_rate > 0``) from a generator seeded with ``seed``, probs cast
    to v's dtype, then PV. Also the function whose gradient the flash path's
    backward takes."""
    qh = q.permute(0, 2, 1, 3).to(torch.float32)          # [B, H, T, D]
    kh = k.permute(0, 2, 3, 1).to(torch.float32)          # [B, H, D, S]
    scores = torch.matmul(qh, kh) * attention_scale(q.shape[-1])
    if bias is not None:
        scores = scores + bias.to(torch.float32)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        gen = torch.Generator(device=q.device).manual_seed(seed)
        keep = torch.rand(probs.shape, generator=gen,
                          device=q.device) >= dropout_rate
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    probs = probs.to(v.dtype)
    ctx = torch.matmul(probs, v.permute(0, 2, 1, 3))      # [B, H, T, D]
    return ctx.permute(0, 2, 1, 3)


def dot_product_attention(
    q: torch.Tensor,                       # [B, T, H, D]
    k: torch.Tensor,                       # [B, S, H, D]
    v: torch.Tensor,                       # [B, S, H, D]
    bias: Optional[torch.Tensor] = None,   # broadcastable to [B, H, T, S]
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    seed: Optional[int] = None,
    use_pallas: bool = False,
    use_fused_dropout: bool = False,
) -> torch.Tensor:
    """Returns [B, T, H, D] in v's dtype; scores and softmax in fp32.
    ``seed`` (an int) fixes the dropout mask; it is required when dropout is
    on (``dropout_rate > 0 and not deterministic``)."""
    if use_pallas and deterministic and k.shape[1] >= 1024:
        from imagetranslate_tpu_torch.ops.flash_attention import (
            flash_attention,
            flash_supported,
        )

        if flash_supported(q, k, bias):
            return flash_attention(q, k, v, bias)
    dropout = dropout_rate > 0.0 and not deterministic
    if dropout and seed is None:
        raise ValueError("attention dropout needs a seed")
    if dropout and use_fused_dropout:
        from imagetranslate_tpu_torch.ops.train_attention import (
            fused_attention_supported,
            fused_dropout_attention,
        )

        # On the CPU the fused op is its plain version with the same mask,
        # so it takes every dtype; the gate is the CUDA kernels'.
        if q.device.type == "cpu" or fused_attention_supported(q, k, bias):
            b = (bias if bias is not None else torch.zeros(
                (q.shape[0], 1, 1, k.shape[1]), dtype=torch.float32,
                device=q.device))
            return fused_dropout_attention(q, k, v, b, float(dropout_rate),
                                           seed)
    return plain_attention(q, k, v, bias,
                           dropout_rate if dropout else 0.0, seed)
