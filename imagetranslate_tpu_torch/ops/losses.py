"""Label-smoothed cross-entropy (port of imagetranslate_tpu/ops/losses.py).

Given raw logits x and targets t, per position

    loss = logZ - (1 - eps) * x_t - (eps / V) * sum_v x_v

which equals (1 - eps) * nll + (eps / V) * smooth on log-softmax outputs. The
full [..., V] logits are kept and positions are masked, never gathered; the
result is (sum, count) so that callers divide once.
"""

from __future__ import annotations

from typing import Tuple

import torch


def smoothed_nll_loss(logits: torch.Tensor, targets: torch.Tensor,
                      mask: torch.Tensor,
                      epsilon: float = 0.1) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """logits [..., V] raw; targets [...] ids; mask [...] bool or float, 1
    where the loss counts. Returns (sum_loss, num_tokens), fp32 scalars."""
    logits = logits.to(torch.float32)
    vocab = logits.shape[-1]
    log_z = torch.logsumexp(logits, dim=-1)
    x_t = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    sum_x = logits.sum(dim=-1)
    loss = log_z - (1.0 - epsilon) * x_t - (epsilon / vocab) * sum_x
    mask_f = mask.to(torch.float32)
    return (loss * mask_f).sum(), mask_f.sum()


def nll_loss(logits: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain NLL: the smoothed loss at epsilon 0."""
    return smoothed_nll_loss(logits, targets, mask, epsilon=0.0)


class _VocabParallelSmoothedNll(torch.autograd.Function):
    """Per-position smoothed NLL over logits whose vocab columns are split
    over the model group: the row max, sum exp, target logit and sum of
    logits each summed (the max maxed) over the group. Backward: the local
    columns of softmax - (1 - eps) onehot(t) - eps / V."""

    @staticmethod
    def forward(ctx, x, targets, epsilon: float, lo: int, vocab: int,
                group):
        from imagetranslate_tpu_torch.parallel.comm import (
            all_reduce_max,
            all_reduce_sum,
        )

        x32 = x.to(torch.float32)
        m = all_reduce_max(x32.max(dim=-1).values, group)
        e = torch.exp(x32 - m[..., None])
        sum_e = all_reduce_sum(e.sum(dim=-1), group)
        local_t = targets.long() - lo
        inside = (local_t >= 0) & (local_t < x.shape[-1])
        local_t = torch.where(inside, local_t, 0)
        x_t = torch.gather(x32, -1, local_t[..., None])[..., 0]
        x_t = all_reduce_sum(torch.where(inside, x_t, 0.0), group)
        sum_x = all_reduce_sum(x32.sum(dim=-1), group)
        ctx.save_for_backward(e, sum_e, local_t, inside)
        ctx.epsilon, ctx.vocab, ctx.dtype = epsilon, vocab, x.dtype
        return (m + torch.log(sum_e)) - (1.0 - epsilon) * x_t \
            - (epsilon / vocab) * sum_x

    @staticmethod
    def backward(ctx, g):
        e, sum_e, local_t, inside = ctx.saved_tensors
        grad = e / sum_e[..., None] - ctx.epsilon / ctx.vocab
        onehot = torch.zeros_like(grad).scatter_(
            -1, local_t[..., None], inside[..., None].to(grad.dtype))
        grad = (grad - (1.0 - ctx.epsilon) * onehot) * g[..., None]
        return grad.to(ctx.dtype), None, None, None, None, None


def smoothed_nll_loss_vocab_parallel(logits: torch.Tensor,
                                     targets: torch.Tensor,
                                     mask: torch.Tensor, epsilon: float,
                                     lo: int, vocab: int, group
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``smoothed_nll_loss`` over this rank's vocab columns [lo, lo + V/n)
    of the logits (``Seq2Seq.project`` under a mesh that splits V), the
    whole vocab ``vocab`` counted through the model group ``group``. Plain
    torch: the JAX step runs its XLA loss under a mesh."""
    loss = _VocabParallelSmoothedNll.apply(logits, targets, epsilon, lo,
                                           vocab, group)
    mask_f = mask.to(torch.float32)
    return (loss * mask_f).sum(), mask_f.sum()
