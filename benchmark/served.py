"""What the two decode kinds share: the stream of batches a window hands the
program's CLI loop, the writer that keeps what it writes, the readings of
the window, and the check of a sample of the served answers against the
plain reference."""

from __future__ import annotations

import time
from typing import Callable, List

import numpy as np

import flops


class Stream:
    """Batches in ``order`` (indices into ``batches``), pass after pass
    until a pass ends at or after ``deadline`` (``time.perf_counter``), so
    that a window decodes whole passes and every run the same batches; or
    ``limit`` batches, or one pass. ``given`` records what was handed
    out."""

    def __init__(self, batches, order, deadline=None, limit=None):
        self.batches, self.order = batches, order
        self.deadline, self.limit = deadline, limit
        self.given: List[int] = []

    def __iter__(self):
        while True:
            for i in self.order:
                if self.limit is not None and len(self.given) >= self.limit:
                    return
                self.given.append(i)
                yield self.batches[i]
            if self.limit is None and (
                    self.deadline is None
                    or time.perf_counter() >= self.deadline):
                return


class Kept:
    """A writer that keeps each ``write`` (the CLI loops write one chunk a
    batch, or one line an image) and discards nothing else."""

    def __init__(self):
        self.chunks: List[str] = []

    def write(self, s: str) -> int:
        self.chunks.append(s)
        return len(s)

    def lines(self) -> List[str]:
        out = []
        for c in self.chunks:
            out += c.rstrip("\n").split("\n")
        return out


def decode_flops(config: dict, beam: int, src_len: int, out_len: int,
                 encode: float) -> float:
    """Model FLOPs of one answered row: its encode (``encode``), the cross
    K/V projections once, and ``beam`` rows of every step that served one of
    its ``out_len`` tokens (live positions 1 .. out_len)."""
    a = flops.decode_step_flops(config, 0, src_len)
    b = flops.decode_step_flops(config, 1, src_len) - a
    n = out_len
    return (encode + flops.cross_kv_flops(config, src_len)
            + beam * (a * n + b * n * (n + 1) / 2))


def kept_calls(order, longest, k: int, seed: int):
    """The calls of ``beam_search`` in the window's first pass whose beam
    trail the check reads: ``k`` positions of the pass drawn from the seed,
    and the position of the batch ``longest`` (the one with the longest
    answers; None where all are alike)."""
    rng = np.random.default_rng(seed + 7)
    pick = set(rng.choice(len(order), size=min(k, len(order)),
                          replace=False).tolist())
    if longest is not None:
        pick.add(list(order).index(longest))
    return sorted(pick)


def sample_rows(n_rows: int, lengths: List[int], k: int, seed: int):
    """``k`` answer indices drawn from the seed, with the longest among
    them."""
    rng = np.random.default_rng(seed)
    pick = set(rng.choice(n_rows, size=min(k, n_rows), replace=False)
               .tolist())
    pick.add(int(np.argmax(lengths)))
    return sorted(pick)


def trail_paths(trail: dict, rows: List[int], lengths: List[int]):
    """For each batch row ``r`` that served ``n`` tokens: the program's own
    score of the hypothesis it served (the top one after step ``n``, the
    row's last live step) and the logsumexp the projection kernel gave at
    each of its ``n`` steps, followed back through the selections (a
    candidate's index over K is the beam it extends)."""
    import torch

    K = trail["K"]
    scores = torch.stack(trail["scores"]).cpu()
    idx = torch.stack(trail["idx"]).cpu()
    lse = torch.stack(trail["lse"]).cpu()
    out = []
    for r, n in zip(rows, lengths):
        slot, path = 0, []
        for i in range(n - 1, -1, -1):
            parent = int(idx[i, r, slot]) // K
            path.append(float(lse[i, r * K + parent]))
            slot = parent
        out.append((float(scores[n - 1, r, 0]), path[::-1]))
    return out


def check_rows(ref_logits: Callable, rows, beam: int, alpha: float,
               pad: int, lower=None):
    """``rows``: (row input, first token + served tokens, the program's
    (score, logsumexp path) from ``trail_paths``); ``ref_logits(rows)`` ->
    the fp32 reference's teacher-forced logits a row, ``lower(rows)`` the
    same one precision step lower (the control). The program's numbers,
    and with ``lower`` the control's in its place over the same tokens:

    - ``topk_gap``: the widest gap of a served token below the reference's
      K-th best logit (the control: of the token it puts K-th);
    - ``score_gap``: the widest relative gap between the score the beam
      gave a served hypothesis and the reference's score of its tokens
      under the same length penalty;
    - ``lse_gap``: the widest gap between the logsumexp at a served
      position and the reference's, in nats.
    """
    import torch

    from reference.decode import (
        control_gap,
        path_numbers,
        served_gap,
    )

    def worse(acc, key, value):
        acc[key] = max(acc[key], float(value))

    prog = {"topk_gap": 0.0, "score_gap": 0.0, "lse_gap": 0.0}
    ctrl = None if lower is None else dict(prog)
    for chunk in range(0, len(rows), 8):
        part = rows[chunk:chunk + 8]
        ref = ref_logits(part)
        low = lower(part) if lower is not None else [None] * len(part)
        for (_, seq, (score, lse)), logits, lo in zip(part, ref, low):
            served = list(seq[1:])
            s_ref, lse_ref = path_numbers(logits, served, alpha, pad)
            worse(prog, "topk_gap", served_gap(logits, served, beam))
            worse(prog, "score_gap", abs(score - s_ref) / abs(s_ref))
            worse(prog, "lse_gap", (torch.as_tensor(lse, dtype=torch.float64)
                                    - lse_ref).abs().max())
            if lo is not None:
                s_lo, lse_lo = path_numbers(lo, served, alpha, pad)
                worse(ctrl, "topk_gap", control_gap(logits, lo, beam))
                worse(ctrl, "score_gap", abs(s_lo - s_ref) / abs(s_ref))
                worse(ctrl, "lse_gap", (lse_lo - lse_ref).abs().max())
    return prog, ctrl
