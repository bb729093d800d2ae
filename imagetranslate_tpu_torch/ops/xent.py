"""Fused label-smoothed softmax cross-entropy (port of
imagetranslate_tpu/ops/xent_pallas.py: ``smoothed_xent_rows`` and
``smoothed_nll_loss_pallas``, here ``smoothed_nll_loss_fused``).

Per row of raw logits x [N, V] with target t, in fp32:

    loss = logZ - (1 - eps) * x_t - (eps / V) * sum_v x_v
    dx   = g * (softmax(x) - (1 - eps) * onehot_t - eps / V)

On a CUDA tensor ``smoothed_xent_rows`` launches the hand-written kernels of
``csrc/xent.cu``: a forward that reads the logits once and also writes logZ,
and a backward that reads the logits and writes dx (in the logits' dtype) and
no other [N, V] tensor. On a CPU tensor it runs
``smoothed_xent_rows_reference``, the plain PyTorch version of the same
function, differentiable by autograd.

The kernels' gate: logits fp32 or bf16, contiguous [N, V] with N >= 1 and any
V >= 1 (a ragged V is handled in the kernel), 16-byte aligned, on an sm_90
card. What fails the gate raises; nothing falls back. A target outside
[0, V) matches no column (x_t = 0), as in the JAX kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from imagetranslate_tpu_torch.ops import _build

# Kernel launches, counted where each kernel is launched and nowhere else.
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0



def _reference_rows(logits, targets, epsilon: float):
    """(loss [N], logZ [N], in-range mask [N], clamped targets [N])."""
    x = logits.to(torch.float32)
    vocab = x.shape[-1]
    t = targets.long()
    inside = (t >= 0) & (t < vocab)
    t = torch.where(inside, t, torch.zeros_like(t))
    log_z = torch.logsumexp(x, dim=-1)
    x_t = torch.gather(x, -1, t[:, None])[:, 0] * inside
    loss = log_z - (1.0 - epsilon) * x_t - (epsilon / vocab) * x.sum(dim=-1)
    return loss, log_z, inside, t


def smoothed_xent_rows_reference(logits: torch.Tensor, targets: torch.Tensor,
                                 epsilon: float = 0.1) -> torch.Tensor:
    """Plain version: logits [N, V], targets [N] -> per-row loss [N] fp32
    (unmasked); its gradient comes from autograd."""
    return _reference_rows(logits, targets, epsilon)[0]


def smoothed_xent_backward_reference(logits, targets, g,
                                     epsilon: float = 0.1) -> torch.Tensor:
    """The backward kernel's formula in plain PyTorch: dx [N, V] in the
    logits' dtype for upstream g [N]."""
    x = logits.to(torch.float32)
    vocab = x.shape[-1]
    _, log_z, inside, t = _reference_rows(logits, targets, epsilon)
    dx = torch.exp(x - log_z[:, None]) - epsilon / vocab
    dx[torch.arange(x.shape[0], device=x.device)[inside], t[inside]] -= (
        1.0 - epsilon)
    return (g.to(torch.float32)[:, None] * dx).to(logits.dtype)


def _check_cuda_args(logits, extra):
    if logits.ndim != 2 or logits.shape[0] < 1 or logits.shape[1] < 1:
        raise ValueError("the fused xent kernels take logits [N >= 1, "
                         f"V >= 1], got {tuple(logits.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("the fused xent kernels take fp32 or bf16 logits, "
                        f"got {logits.dtype}")
    n = logits.shape[0]
    for name, t, dtype in extra:
        if t.shape != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    for name, t in (("logits", logits), *((n_, t_) for n_, t_, _ in extra)):
        if t.device != logits.device:
            raise ValueError(f"{name} must be on {logits.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if logits.data_ptr() % 16:
        raise ValueError("logits must be 16-byte aligned")
    _build.require_hopper(logits.device, "the fused xent kernels are")


def _scalars(vocab: int, epsilon: float):
    return float(1.0 - epsilon), float(epsilon / vocab)


def _launch_fwd(logits, targets, epsilon: float):
    """logits [N, V], targets [N] int64 -> (loss [N], logZ [N]) fp32."""
    global FWD_LAUNCHES
    _check_cuda_args(logits, (("targets", targets, torch.int64),))
    lib = _build.load()
    n, vocab = logits.shape
    loss = torch.empty((n,), dtype=torch.float32, device=logits.device)
    log_z = torch.empty_like(loss)
    with torch.cuda.device(logits.device):
        err = lib.itt_xent_fwd(
            logits.data_ptr(), targets.data_ptr(), loss.data_ptr(),
            log_z.data_ptr(), n, vocab, int(logits.dtype == torch.bfloat16),
            *_scalars(vocab, epsilon),
            torch.cuda.current_stream(logits.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused xent forward launch failed: "
                           + lib.itt_error_string(err).decode())
    FWD_LAUNCHES += 1
    return loss, log_z


def _launch_bwd(logits, targets, log_z, g, epsilon: float):
    """dx [N, V] in the logits' dtype; g [N] fp32."""
    global BWD_LAUNCHES
    _check_cuda_args(logits, (("targets", targets, torch.int64),
                              ("log_z", log_z, torch.float32),
                              ("g", g, torch.float32)))
    lib = _build.load()
    n, vocab = logits.shape
    dx = torch.empty_like(logits)
    with torch.cuda.device(logits.device):
        err = lib.itt_xent_bwd(
            logits.data_ptr(), targets.data_ptr(), log_z.data_ptr(),
            g.data_ptr(), dx.data_ptr(), n, vocab,
            int(logits.dtype == torch.bfloat16), *_scalars(vocab, epsilon),
            torch.cuda.current_stream(logits.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused xent backward launch failed: "
                           + lib.itt_error_string(err).decode())
    BWD_LAUNCHES += 1
    return dx


class _SmoothedXentRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, epsilon):
        loss, log_z = _launch_fwd(logits, targets, epsilon)
        ctx.save_for_backward(logits, targets, log_z)
        ctx.epsilon = epsilon
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, targets, log_z = ctx.saved_tensors
        # g arrives as mask / n broadcast: make it a dense fp32 [N].
        dx = _launch_bwd(logits, targets, log_z,
                         g.to(torch.float32).contiguous(), ctx.epsilon)
        return dx, None, None


def smoothed_xent_rows(logits: torch.Tensor, targets: torch.Tensor,
                       epsilon: float = 0.1) -> torch.Tensor:
    """Per-row label-smoothed cross-entropy [N] fp32 (unmasked) of logits
    [N, V] against targets [N].

    A CPU tensor runs the plain version; a CUDA tensor launches the kernels
    (fp32 or bf16 logits, contiguous, 16-byte aligned, sm_90) or raises."""
    epsilon = float(epsilon)
    if logits.device.type == "cpu":
        return smoothed_xent_rows_reference(logits, targets, epsilon)
    if logits.device.type != "cuda":
        raise ValueError("smoothed_xent_rows runs on cpu or cuda, not "
                         f"{logits.device}")
    return _SmoothedXentRows.apply(
        logits, targets.to(torch.int64).contiguous(), epsilon)


def smoothed_nll_loss_fused(logits: torch.Tensor, targets: torch.Tensor,
                            mask: torch.Tensor,
                            epsilon: float = 0.1) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """Drop-in for ``ops.losses.smoothed_nll_loss`` through the fused
    kernels: logits [..., V], targets and mask [...]; returns (sum_loss,
    num_tokens), fp32 scalars. Every row is computed; the mask multiplies the
    rows, so a masked row's gradient is zero."""
    vocab = logits.shape[-1]
    mask_f = mask.reshape(-1).to(torch.float32)
    rows = smoothed_xent_rows(logits.reshape(-1, vocab), targets.reshape(-1),
                              epsilon)
    return (rows * mask_f).sum(), mask_f.sum()
