"""The served tokens held against the plain reference.

Beam search with K beams appends to a hypothesis only a token among the K
best of the model's distribution after that hypothesis's prefix (the
per-beam top-K of the two-stage selection), so every token of a served
output lies at or above the K-th best logit of the reference's distribution
at its position, up to the rounding of the program that served it. The
reference runs once, teacher-forced, over each source or image with the
served tokens (fp32, every position at once) and reads, at each position,
by how much the served token's logit lies below the K-th best logit (0 when
it lies in the reference's top K). ``control_gap`` reads the same gap for the
token that a lower precision puts K-th at each position, over the same
prefixes: what a decode in that precision could serve. ``path_numbers``
gives the reference's score of the served tokens under the beam's length
penalty and its logsumexp at each position, which the program's own score
and its projection kernel's logsumexp are held to.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from reference.model import Seq2SeqRef


def teacher_forced_logits(model: Seq2SeqRef, enc, enc_keep, seqs:
                          Sequence[Sequence[int]], langs: Sequence[int],
                          device) -> List[torch.Tensor]:
    """For each row r, the logits [n_r, V] the model gives after each prefix
    of ``seqs[r]`` (its first token and the served tokens but the last);
    ``enc`` [R, S, E] and ``enc_keep`` [R, S] are the rows' encoder states
    and their keep-mask."""
    R = len(seqs)
    n = max(len(s) for s in seqs) - 1
    tokens = torch.zeros((R, n), dtype=torch.long, device=device)
    live = torch.zeros((R, n), dtype=torch.bool, device=device)
    for r, s in enumerate(seqs):
        tokens[r, :len(s) - 1] = torch.as_tensor(list(s[:-1]))
        live[r, :len(s) - 1] = True
    causal = torch.tril(torch.ones((n, n), dtype=torch.bool, device=device))
    self_keep = (causal[None] & live[:, None, :])[:, None]
    pos = torch.arange(n, device=device)[None].expand(R, n)
    lang = torch.as_tensor(list(langs), device=device)[:, None].expand(R, n)
    hidden = model.decode(enc, tokens, pos, lang, self_keep,
                          enc_keep[:, None, None, :])
    return [model.project(hidden[r, :len(s) - 1])
            for r, s in enumerate(seqs)]


def served_gap(logits: torch.Tensor, served: Sequence[int], k: int) -> float:
    """Widest gap over the positions: K-th best logit less the served
    token's, 0 where the served token is among the K best."""
    kth = torch.topk(logits, k, dim=-1).values[:, -1]
    got = logits.gather(1, torch.as_tensor(list(served), device=logits.device
                                           )[:, None])[:, 0]
    return float(torch.clamp(kth - got, min=0.0).max())


def control_gap(logits: torch.Tensor, lower: torch.Tensor, k: int) -> float:
    """The same gap for the token that ``lower`` (the logits of a lower
    precision at the same positions) puts K-th."""
    tok = torch.topk(lower, k, dim=-1).indices[:, -1]
    kth = torch.topk(logits, k, dim=-1).values[:, -1]
    got = logits.gather(1, tok[:, None])[:, 0]
    return float(torch.clamp(kth - got, min=0.0).max())


def path_numbers(logits: torch.Tensor, served: Sequence[int], alpha: float,
                 pad: int):
    """The score of the served tokens under the GNMT length penalty's
    compounding recurrence, s_i = (s_{i-1} + log p_i) / ((n_{i-1} + 6) /
    6)^alpha with n_{i-1} the non-pad tokens before position i, in float64
    on the host; and the logsumexp at each position [n] (float64, host)."""
    x = logits.double().cpu()
    lse = torch.logsumexp(x, dim=-1)
    tok = torch.as_tensor(list(served))
    logp = (x.gather(1, tok[:, None])[:, 0] - lse).tolist()
    score, size = 0.0, 0
    for lp, t in zip(logp, served):
        score = (score + lp) / ((size + 6.0) / 6.0) ** alpha
        size += int(t) != pad
    return score, lse
