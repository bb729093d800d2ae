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
