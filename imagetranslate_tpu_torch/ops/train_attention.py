"""Fused training attention with in-kernel dropout (port of
imagetranslate_tpu/ops/train_attention.py::fused_dropout_attention).

``softmax(q k^T * scale + bias)`` in fp32, a Bernoulli keep-mask drawn from a
seed, kept probs divided by ``1 - rate``, cast to v's dtype, times v. On a
CUDA tensor ``fused_dropout_attention`` launches the hand-written kernels of
``csrc/train_attention.cu``: a flash-style forward that also writes each
row's logsumexp as (max, log sum) and, when a backward will follow at rate >
0, the keep bits it drew (``pack_keep_bits``' layout); and a backward (a dq
kernel, then a dk/dv kernel) that recomputes the probs from the row
statistics and reads the saved bits, so the inputs, the output, those
statistics and the bits are all that is saved between them. On a CPU tensor
it runs ``fused_dropout_attention_reference``, the plain PyTorch version of
the same function.

The mask is a pure function of ``(seed, b, h, t, s)``: Philox-4x32-10 keyed on
the 64-bit seed with the counter ``(s // 4, t, h, b)``, output ``s % 4``; a
prob is kept iff its 32 bits are >= ``round(rate * 2**32)``. The plain
version draws the same bits with torch integer ops (``philox_bits``), so the
kernels are held against it element by element at rate > 0, forward and
gradients. (The TPU kernel seeds a per-program hardware stream; the two
masks differ bit for bit and are equally distributed.)

Numerics contract (that of the JAX kernel): fp32 scores and softmax, the
scale of ``ops.attention.attention_scale``, probs cast to v's dtype before
the product with v, fp32 contractions in the backward, fp32 dbias in the
bias's shape. The plain version follows it exactly. The kernels round the
un-normalised probs to bf16 and divide by the row sum and by ``1 - rate``
last (as the flash attention kernel does), and feed ds and the dropped probs
to the backward's products in bf16. The backward takes delta =
rowsum(g * out) over the bf16 output
(``fused_dropout_attention_backward_saved`` is that formula in plain
PyTorch), or, when dbias is asked for, the exact rowsum(p * dp) in fp32;
dbias stays fp32. ``chip_smoke.py`` holds them to the
plain version within 2^-6 of the largest output (1e-4 for dbias).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from imagetranslate_tpu_torch.ops import _build
from imagetranslate_tpu_torch.ops.attention import attention_scale

# Kernel launches, counted where each kernel is launched and nowhere else.
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF

# The kernels' shape limits (csrc/train_attention.cu), repeated here so that
# the shape gate answers without a build; chip_smoke.py holds the gate against
# the library's own itt_fused_attn_supported on the card.
_MAX_S = 512
_HEAD_DIMS = (16, 32, 64, 128)


def _keep_threshold(rate: float) -> int:
    """uint32 threshold t: keep iff bits >= t, so P(keep) = 1 - rate to
    within 2^-32."""
    t = int(round(rate * 4294967296.0))
    return min(max(t, 0), 4294967295)


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32 bits of m * x for x in [0, 2^32) held in int64,
    without overflowing int64: x is split into 16-bit halves."""
    p1 = (x >> 16) * m                       # < 2^48
    low = (x & 0xFFFF) * m + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (low >> 32), low & _MASK32


def philox4x32_10(counter, key):
    """Philox-4x32-10 (Salmon et al., "Parallel random numbers: as easy as
    1, 2, 3"). counter: four int64 tensors (or ints) with values in
    [0, 2^32); key: two ints. Returns the four output words as int64
    tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (int(k) & _MASK32 for k in key)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def philox_bits(seed: int, B: int, H: int, T: int, S: int,
                device=None) -> torch.Tensor:
    """The 32 random bits of every (b, h, t, s), as int64 [B, H, T, S]."""
    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    groups = -(-S // 4)
    words = philox4x32_10(
        (ar(groups)[None, None, None, :], ar(T)[None, None, :, None],
         ar(H)[None, :, None, None], ar(B)[:, None, None, None]),
        (seed & _MASK32, (seed >> 32) & _MASK32))
    bits = torch.stack([w.expand(B, H, T, groups) for w in words], dim=-1)
    return bits.reshape(B, H, T, groups * 4)[..., :S]


def keep_mask(rate: float, seed: int, B: int, H: int, T: int, S: int,
              device=None) -> torch.Tensor:
    """The boolean keep-mask [B, H, T, S] both kernels draw."""
    return philox_bits(seed, B, H, T, S, device) >= _keep_threshold(rate)


def keep_words(S: int) -> int:
    """Words of a row of saved keep bits: 32 keys to a uint32 word, rounded
    up to four words (16 bytes, the stride a TMA copy needs)."""
    words = -(-S // 32)
    return -(-words // 4) * 4


def pack_keep_bits(keep: torch.Tensor) -> torch.Tensor:
    """The keep bits the forward kernel saves: bool [B, H, T, S] -> int32
    [B, H, T, keep_words(S)] (the kernels read the words as uint32), bit i
    of word w is key 32 w + i; keys past S and the padding words are 0."""
    B, H, T, S = keep.shape
    W = keep_words(S)
    padded = torch.zeros((B, H, T, 32 * W), dtype=torch.int64,
                         device=keep.device)
    padded[..., :S] = keep.to(torch.int64)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=keep.device),
        torch.arange(32, device=keep.device))
    words = (padded.view(B, H, T, W, 32) * weights).sum(-1)
    return words.to(torch.int32)    # the low 32 bits, two's complement


def unpack_keep_bits(words: torch.Tensor, S: int) -> torch.Tensor:
    """The inverse of ``pack_keep_bits``: int32 [B, H, T, W] -> bool
    [B, H, T, S]."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return bits.flatten(-2)[..., :S].bool()


def _probs(q, k, bias):
    scores = torch.einsum("bthd,bshd->bhts", q.to(torch.float32),
                          k.to(torch.float32)) * attention_scale(q.shape[-1])
    return torch.softmax(scores + bias.to(torch.float32), dim=-1)


def fused_dropout_attention_reference(q, k, v, bias, rate: float, seed: int):
    """Plain version. q [B, T, H, D]; k, v [B, S, H, D]; bias fp32
    [B, 1, 1|T, S]. Returns [B, T, H, D] in v's dtype; differentiable by
    autograd."""
    B, T, H, _ = q.shape
    probs = _probs(q, k, bias)
    if rate > 0.0:
        keep = keep_mask(rate, seed, B, H, T, k.shape[1], q.device)
        probs = torch.where(keep, probs / (1.0 - rate), 0.0)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)


def fused_dropout_attention_backward_reference(q, k, v, bias, g, rate: float,
                                               seed: int):
    """The backward kernel's formulas in plain PyTorch, fp32 contractions:
    returns (dq, dk, dv) in the input dtypes and dbias fp32 in bias's
    shape."""
    B, T, H, _ = q.shape
    scale = attention_scale(q.shape[-1])
    p = _probs(q, k, bias)
    g32, v32 = g.to(torch.float32), v.to(torch.float32)
    dp = torch.einsum("bthd,bshd->bhts", g32, v32)
    p_drop = p
    if rate > 0.0:
        keep = keep_mask(rate, seed, B, H, T, k.shape[1], q.device)
        p_drop = torch.where(keep, p / (1.0 - rate), 0.0)
        dp = torch.where(keep, dp / (1.0 - rate), 0.0)
    dv = torch.einsum("bhts,bthd->bshd", p_drop, g32)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhts,bshd->bthd", ds, k.to(torch.float32)) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, q.to(torch.float32)) * scale
    dbias = ds.sum(dim=1, keepdim=True)
    if bias.shape[2] == 1:
        dbias = dbias.sum(dim=2, keepdim=True)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def fused_dropout_attention_backward_saved(q, k, v, bias, g, out, words,
                                            rate: float):
    """The backward kernels' formulas in plain PyTorch, fp32 contractions:
    the keep-mask from the forward's saved words (``pack_keep_bits``; None
    where ``draws_mask(rate)`` is false, which keeps every key) and delta = rowsum(g * out) over the forward's output ``out``.
    Returns (dq, dk, dv) in the input dtypes; the kernels take this path
    where dbias is not asked for."""
    scale = attention_scale(q.shape[-1])
    p = _probs(q, k, bias)
    g32 = g.to(torch.float32)
    dp = torch.einsum("bthd,bshd->bhts", g32, v.to(torch.float32))
    p_drop = p
    if rate > 0.0:
        keep = (torch.ones_like(p, dtype=torch.bool) if words is None
                else unpack_keep_bits(words, k.shape[1]))
        p_drop = torch.where(keep, p / (1.0 - rate), 0.0)
        dp = torch.where(keep, dp / (1.0 - rate), 0.0)
    delta = (g32 * out.to(torch.float32)).sum(-1).transpose(1, 2)[..., None]
    dv = torch.einsum("bhts,bthd->bshd", p_drop, g32)
    ds = p * (dp - delta)
    dq = torch.einsum("bhts,bshd->bthd", ds, k.to(torch.float32)) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, q.to(torch.float32)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fused_attention_supported(q: torch.Tensor, k: torch.Tensor,
                              bias: Optional[torch.Tensor]) -> bool:
    """The shape gate of the CUDA kernels: bf16 q/k, bias None or fp32
    [B, 1, 1|T, S], D in {16, 32, 64, 128}, 1 <= S <= 512 (the JAX gate's
    cap), any T, B and H <= 65535. Keys stream through the kernels in tiles,
    so shared memory sets no limit of its own. What fails the gate takes the
    plain path."""
    B, T, H, D = q.shape
    S = k.shape[1]
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16:
        return False
    if bias is not None:
        if bias.ndim != 4 or bias.shape[0] != B or bias.shape[1] != 1:
            return False
        if bias.shape[2] not in (1, T) or bias.shape[3] != S:
            return False
    return (D in _HEAD_DIMS and 1 <= S <= _MAX_S and T >= 1
            and 1 <= B <= 65535 and 1 <= H <= 65535)


def _check_cuda_args(q, k, v, bias, extra=()):
    B, T, H, D = q.shape
    S = k.shape[1]
    if k.shape != (B, S, H, D) or v.shape != k.shape:
        raise ValueError(f"k and v must be [{B}, S, {H}, {D}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the fused attention kernels take bf16 {name}, "
                            f"got {t.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"the fused attention kernels take an fp32 bias, "
                        f"got {bias.dtype}")
    if not fused_attention_supported(q, k, bias):
        raise ValueError(
            f"shape outside the fused attention kernels' gate: q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, bias "
            f"{tuple(bias.shape)} (see fused_attention_supported)")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias), *extra):
        if t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _build.require_hopper(q.device, "the fused attention kernels are")


def draws_mask(rate: float) -> bool:
    """Whether the kernels draw a mask at ``rate``: a rate below 2^-33
    rounds to threshold 0, which keeps every key. The one test that decides
    whether the forward saves keep bits and the backward reads them."""
    return rate > 0.0 and _keep_threshold(rate) > 0


def _scalars(q, rate: float, seed: int):
    return (attention_scale(q.shape[-1]), float(1.0 - rate),
            _keep_threshold(rate) if draws_mask(rate) else 0,
            seed & _MASK32, (seed >> 32) & _MASK32)


def _stat_rows(T: int) -> int:
    """Row stride of the kernels' per-row statistics and delta: T rounded up
    to 4, so that each (batch row, head) starts on 16 bytes (a TMA
    stride)."""
    return -(-T // 4) * 4


def _launch_fwd(q, k, v, bias, rate, seed, save_bits: bool):
    """Returns the output, the row statistics [B, H, Tp, 2] fp32 (the max
    and the log of the sum of each row's exp(x - max), rows padded to
    ``_stat_rows(T)``) and, when ``save_bits`` and ``draws_mask(rate)``,
    the keep bits as ``pack_keep_bits`` lays them out (else None): what the
    backward needs."""
    global FWD_LAUNCHES
    _check_cuda_args(q, k, v, bias)
    lib = _build.load()
    B, T, H, D = q.shape
    S = k.shape[1]
    out = torch.empty_like(q)
    stats = torch.empty((B, H, _stat_rows(T), 2), dtype=torch.float32,
                        device=q.device)
    bits = None
    if save_bits and draws_mask(rate):
        bits = torch.empty((B, H, T, keep_words(S)), dtype=torch.int32,
                           device=q.device)
    with torch.cuda.device(q.device):
        err = lib.itt_fused_attn_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), stats.data_ptr(),
            None if bits is None else bits.data_ptr(), B, T, S, H, D,
            int(bias.shape[2] != 1), *_scalars(q, rate, seed),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused attention forward launch failed: "
                           + lib.itt_error_string(err).decode())
    FWD_LAUNCHES += 1
    return out, stats, bits


def _launch_bwd(q, k, v, bias, g, out, stats, bits, rate, want_dbias: bool):
    """dq, dk, dv and (when ``want_dbias``) dbias from the forward's output,
    row statistics and keep bits (None where ``draws_mask(rate)`` is
    false)."""
    global BWD_LAUNCHES
    _check_cuda_args(q, k, v, bias, extra=(("g", g), ("out", out)))
    B, T, H, D = q.shape
    S = k.shape[1]
    Tp = _stat_rows(T)
    if (stats.shape != (B, H, Tp, 2) or stats.dtype != torch.float32
            or not stats.is_contiguous() or stats.device != q.device):
        raise ValueError(f"stats must be the forward's contiguous fp32 "
                         f"[{B}, {H}, {Tp}, 2], got {tuple(stats.shape)} "
                         f"{stats.dtype}")
    if out.shape != q.shape:
        raise ValueError(f"out must be [{B}, {T}, {H}, {D}], got "
                         f"{tuple(out.shape)}")
    drop = draws_mask(rate)
    if drop:
        want = (B, H, T, keep_words(S))
        if (bits is None or bits.shape != want or bits.dtype != torch.int32
                or not bits.is_contiguous() or bits.device != q.device):
            raise ValueError(f"where a mask is drawn the backward reads the "
                             f"forward's keep bits, int32 {want}")
    lib = _build.load()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # delta per row: written by the dq kernel, read by dk/dv.
    delta = torch.empty((B, H, Tp), dtype=torch.float32, device=q.device)
    part = dbias = None
    if want_dbias:
        part = torch.empty((B, H, bias.shape[2], S), dtype=torch.float32,
                           device=q.device)
        dbias = torch.empty_like(bias)
    with torch.cuda.device(q.device):
        err = lib.itt_fused_attn_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            g.data_ptr(), out.data_ptr(), stats.data_ptr(),
            bits.data_ptr() if drop else None, delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(),
            None if dbias is None else dbias.data_ptr(),
            B, T, S, H, D, int(bias.shape[2] != 1),
            attention_scale(D), float(1.0 - rate),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused attention backward launch failed: "
                           + lib.itt_error_string(err).decode())
    BWD_LAUNCHES += 1
    return dq, dk, dv, dbias


class _FusedDropoutAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, rate, seed):
        # The keep bits are saved only where a backward can follow.
        out, stats, bits = _launch_fwd(q, k, v, bias, rate, seed,
                                       any(ctx.needs_input_grad[:4]))
        ctx.save_for_backward(q, k, v, bias, out, stats, bits)
        ctx.rate = rate
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, stats, bits = ctx.saved_tensors
        dq, dk, dv, dbias = _launch_bwd(q, k, v, bias, g.contiguous(), out,
                                        stats, bits, ctx.rate,
                                        ctx.needs_input_grad[3])
        return dq, dk, dv, dbias, None, None


def fused_dropout_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: torch.Tensor, rate: float,
                            seed: int) -> torch.Tensor:
    """q [B, T, H, D]; k, v [B, S, H, D]; bias additive fp32 [B, 1, 1|T, S];
    rate: dropout rate; seed: int in [0, 2^64), same seed -> same mask (which
    is how the backward reproduces it). Returns [B, T, H, D].

    A CPU tensor runs the plain version; a CUDA tensor launches the kernels
    (bf16 q/k/v, fp32 bias, contiguous, inside ``fused_attention_supported``)
    or raises."""
    rate, seed = float(rate), int(seed)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if q.device.type == "cpu":
        return fused_dropout_attention_reference(q, k, v, bias, rate, seed)
    if q.device.type != "cuda":
        raise ValueError("fused_dropout_attention runs on cpu or cuda, not "
                         f"{q.device}")
    return _FusedDropoutAttention.apply(q, k, v, bias, rate, seed)
