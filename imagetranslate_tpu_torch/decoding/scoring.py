"""Forced-decoding scores (port of imagetranslate_tpu/decoding/scoring.py):
the mean per-token log-probability of a target given a source under an MT
model, which ``cli.score_pairs`` uses to pick the best translation candidate
of each source."""

from __future__ import annotations

import torch


@torch.no_grad()
def forced_score(model, src, src_mask, tgt, tgt_mask, src_langs,
                 tgt_langs) -> torch.Tensor:
    """-> [B] fp32: the mean log-probability of tgt[:, 1:] under teacher
    forcing (log_softmax in fp32; rows without a target score 0)."""
    logits = model(src, src_mask, tgt, tgt_mask, src_langs, tgt_langs)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    tok_lp = torch.gather(logp, -1, tgt[:, 1:, None].long())[..., 0]
    mask = tgt_mask[:, 1:].to(torch.float32)
    return torch.sum(tok_lp * mask, dim=1) / torch.clamp(
        torch.sum(mask, dim=1), min=1.0)
