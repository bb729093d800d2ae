"""Philox-4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011) and the attention-dropout keep-mask drawn from it: the mask is a
pure function of ``(seed, b, h, t, s)``, the counter ``(s // 4, t, h, b)``
keyed on the 64-bit seed, output word ``s % 4``; a probability is kept iff its
32 bits are >= round(rate * 2^32). This is the mask the configuration's
fused training attention documents; the reference draws it again from the
seed."""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    """High and low 32 bits of m * x for x in [0, 2^32) held in int64."""
    p1 = (x >> 16) * m
    low = (x & 0xFFFF) * m + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (low >> 32), low & _MASK32


def philox4x32_10(counter, key):
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (int(k) & _MASK32 for k in key)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def keep_mask(rate: float, seed: int, B: int, H: int, T: int, S: int,
              device=None) -> torch.Tensor:
    """bool [B, H, T, S]: True where the probability is kept."""
    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    groups = -(-S // 4)
    words = philox4x32_10(
        (ar(groups)[None, None, None, :], ar(T)[None, None, :, None],
         ar(H)[None, :, None, None], ar(B)[:, None, None, None]),
        (seed & _MASK32, (seed >> 32) & _MASK32))
    bits = torch.stack([w.expand(B, H, T, groups) for w in words], dim=-1)
    bits = bits.reshape(B, H, T, groups * 4)[..., :S]
    threshold = min(max(int(round(rate * 4294967296.0)), 0), 4294967295)
    return bits >= threshold
