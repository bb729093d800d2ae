"""The numbers that decide ``correct``, each read from the program's output
and the plain reference's, and the limits they are held to
(``limits/<cell>.json``: name -> limit, and how the limit was set).

Training (the first three steps of the window's own call and feed):
- ``loss_gap``: the largest relative gap between a step's loss and the
  reference's;
- ``grad_gap``: the first step's clipped gradient as the optimizer holds it
  (Adam's first moment after one update over 1 - b1), the worst parameter's
  gap between the program's norm and the reference's, over the larger of the
  reference's norm of that parameter and of the median parameter;
- ``grad_diff``: the norm of the difference between that gradient and the
  reference's, the worst parameter's, over the same denominator: the gaps
  of norms above average rounding out, and a precision one step lower
  reads only about twice bfloat16's in them, while this reads it at ten
  times;
- ``delta_gap``: the same for each parameter's change over the three steps,
  leaving out the parameters whose reference gradient is under a thousandth
  of the median parameter's (rounding alone moves them under Adam, as a key
  bias under softmax).

Decoding: ``topk_gap``, the widest gap by which a sampled served token's
reference logit lies below the reference's K-th best (``reference/decode.py``),
and ``wrong_lengths``, the answers of the window whose token count is not the
row's limit (every row decodes to its limit: the separator lies outside the
vocabulary).
"""

from __future__ import annotations

import json
import os
import statistics
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
SMALL_GRAD = 1e-3


def limits(cell: str) -> Dict[str, float]:
    with open(os.path.join(HERE, "limits", cell + ".json")) as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()}


def _norm_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keep: List[str]) -> float:
    median = statistics.median(ref[k] for k in keep)
    return max(abs(prog[k] - ref[k]) / max(ref[k], median) for k in keep)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"loss": [..], "grad": {name: norm},
    "grad_vec": {name: tensor}, "delta": {name: norm}}."""
    import torch

    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    names = list(ref["grad"])
    grad = _norm_gaps(prog["grad"], ref["grad"], names)
    median = statistics.median(ref["grad"][k] for k in names)
    diff = max(float(torch.linalg.vector_norm(
        prog["grad_vec"][k].to(ref["grad_vec"][k].device)
        - ref["grad_vec"][k])) / max(ref["grad"][k], median) for k in names)
    moved = [k for k in names if ref["grad"][k] >= SMALL_GRAD * median]
    delta = _norm_gaps(prog["delta"], ref["delta"], moved)
    return {"loss_gap": loss, "grad_gap": grad, "grad_diff": diff,
            "delta_gap": delta}


def held(numbers: Dict[str, float], lim: Dict[str, float]) -> Dict[str, dict]:
    """The compared numbers beside their limits: those the cell's limits
    file names (a number without an upper reading is read and not
    compared)."""
    return {k: {"value": v, "limit": lim[k]} for k, v in numbers.items()
            if k in lim}
