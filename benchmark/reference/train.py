"""Three training steps of the translation model in plain PyTorch, fp32: the
reference that the first steps of a training cell are held against.

The objective is the label-smoothed cross-entropy over the target positions
that predict a token of the same example, summed and divided by their count.
The update is Adam (0.9, 0.98, eps 1e-8 added after both bias corrections)
after a clip of the gradients' global norm, with the inverse-sqrt warmup
schedule (from 1e-7 up to ``lr`` over ``warmup`` updates), the optimizer the
reference repository trains with."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from reference.model import (
    DropoutStream,
    Seq2SeqRef,
    segment_keep,
    smoothed_loss_rows,
)
from reference.precision import FP32

B1, B2, EPS = 0.9, 0.98, 1e-8
WARMUP_INIT = 1e-7


def learning_rate(k: int, lr: float, warmup: int) -> float:
    """The rate of the update made after k earlier updates."""
    if k < warmup:
        return WARMUP_INIT + k * (lr - WARMUP_INIT) / warmup
    return min(max(lr * warmup ** 0.5 / max(k, 1) ** 0.5, WARMUP_INIT), lr)


def batch_inputs(b, device) -> Dict[str, torch.Tensor]:
    """A host batch (packed rows with segment ids, or padded rows with
    masks) -> the decoder's and encoder's inputs, attention keep-masks and
    the loss mask."""
    def t(x):
        return torch.as_tensor(np.asarray(x)).to(device)

    if hasattr(b, "src_seg"):
        src, sseg, spos = t(b.src).long(), t(b.src_seg), t(b.src_pos).long()
        dst, dseg, dpos = t(b.dst).long(), t(b.dst_seg), t(b.dst_pos).long()
        tseg = dseg[:, :-1]
        return dict(
            src=src, src_pos=spos, dst=dst, dst_pos=dpos[:, :-1],
            enc_keep=segment_keep(sseg, sseg),
            self_keep=segment_keep(tseg, tseg, causal=True),
            cross_keep=segment_keep(tseg, sseg),
            loss_mask=(dseg[:, 1:] == dseg[:, :-1]) & (dseg[:, 1:] > 0),
            src_langs=t(b.src_langs).long(), dst_langs=t(b.dst_langs).long())
    src, smask = t(b.src).long(), t(b.src_mask).bool()
    dst, dmask = t(b.dst).long(), t(b.dst_mask).bool()
    B, S = src.shape
    T = dst.shape[1] - 1
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=device))
    return dict(
        src=src, src_pos=torch.arange(S, device=device)[None].expand(B, S),
        dst=dst, dst_pos=torch.arange(T, device=device)[None].expand(B, T),
        enc_keep=smask[:, None, None, :],
        self_keep=(causal[None] & dmask[:, None, :-1])[:, None],
        cross_keep=smask[:, None, None, :],
        loss_mask=dmask[:, 1:] & t(b.row_mask).bool()[:, None],
        src_langs=t(b.src_langs).long(), dst_langs=t(b.dst_langs).long())


def objective(model: Seq2SeqRef, x, drop, eps: float, rows=None):
    """(sum of the loss, count of its positions); ``rows``: only these rows
    (a fault the check must catch: part of the batch left out)."""
    if rows is not None:
        x = {k: v[rows] for k, v in x.items()}
    B, S = x["src"].shape
    T = x["dst_pos"].shape[1]
    enc = model.encode(x["src"], x["src_pos"],
                       x["src_langs"][:, None].expand(B, S), x["enc_keep"],
                       drop)
    hidden = model.decode(enc, x["dst"][:, :-1], x["dst_pos"],
                          x["dst_langs"][:, None].expand(B, T),
                          x["self_keep"], x["cross_keep"], drop)
    mask = x["loss_mask"].to(torch.float32)
    total = torch.zeros((), device=mask.device)
    # The projection and the loss a block of rows at a time: the fp32
    # logits of a whole batch are the largest tensor of the step.
    for lo in range(0, B, 16):
        logits = model.project(hidden[lo:lo + 16])
        rows_loss = smoothed_loss_rows(logits, x["dst"][lo:lo + 16, 1:], eps)
        total = total + (rows_loss * mask[lo:lo + 16]).sum()
    return total, mask.sum()


def train_steps(W0: Dict[str, torch.Tensor], cfg: dict, batches: List,
                seed: int, device, prec=FP32, half_batch: bool = False):
    """Three (or ``len(batches)``) steps from the weights ``W0`` (fp32,
    not modified) on the host batches, the dropout drawn from ``seed``.
    Returns the losses, the first step's clipped gradient (and its norm)
    per parameter and the norm of each parameter's change over the
    steps."""
    train = cfg["train"]
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in W0.items()}
    mu = {k: torch.zeros_like(v) for k, v in W0.items()}
    nu = {k: torch.zeros_like(v) for k, v in W0.items()}
    host = torch.Generator().manual_seed(int(seed))
    model = Seq2SeqRef(params, cfg, prec)
    losses, grad_norms, grad_vec = [], None, None
    for step, b in enumerate(batches):
        x = batch_inputs(b, device)
        drop = DropoutStream(host, device, cfg["dropout"],
                             cfg["attention_dropout"])
        rows = None
        if half_batch:
            rows = slice(0, x["src"].shape[0] // 2)
        total, n = objective(model, x, drop, train["label_smoothing"], rows)
        loss = total / n.clamp(min=1.0)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, grads)]
        with torch.no_grad():
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
            factor = min(1.0, train["clip"] / float(norm))
            grads = [g * factor for g in grads]
            if step == 0:
                grad_norms = {k: float(g.norm()) for k, g in zip(names, grads)}
                grad_vec = dict(zip(names, grads))
            t = step + 1
            lr = learning_rate(step, train["lr"], train["warmup"])
            for k, g in zip(names, grads):
                mu[k].mul_(B1).add_(g, alpha=1 - B1)
                nu[k].mul_(B2).addcmul_(g, g, value=1 - B2)
                upd = (mu[k] / (1 - B1 ** t)) / (
                    torch.sqrt(nu[k] / (1 - B2 ** t)) + EPS)
                params[k].sub_(upd, alpha=lr)
        losses.append(float(loss.detach()))
    with torch.no_grad():
        deltas = {k: float((params[k] - W0[k]).norm()) for k in params}
    return {"loss": losses, "grad": grad_norms, "grad_vec": grad_vec,
            "delta": deltas}
