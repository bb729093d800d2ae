"""Text traffic from a mix file's parameters: sentence lengths and token ids.

Every seed gets the same multiset of lengths (the log-normal's quantiles at
evenly spaced points, clipped, and target lengths from a fixed set of
ratios paired by a fixed permutation), so the batches a seed builds have the
same shapes and the work of a run does not depend on its seed. The seed
draws the token ids: ordinary tokens ``first_word + (V - first_word) u^3``
(a skewed vocabulary, as text's is), between a language token and the
closing separator.
"""

from __future__ import annotations

import math
import statistics
from typing import List, Tuple

import numpy as np

# The stand-in vocabulary's special ids (the trainer reads them through the
# tokenizer facade in ``vocab.py``): pad 0, bos 1, unk 2, mask 3, separator
# 4, then the two language tokens.
SEP = 4
LANG_TOKENS = (5, 6)
FIRST_WORD = 7


def lengths(n: int, spec: dict) -> np.ndarray:
    """n lengths (tokens, the language token and the separator included):
    the quantiles (i + 1/2) / n of log-normal(median, sigma), clipped."""
    dist = statistics.NormalDist()
    z = np.array([dist.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def paired_lengths(n: int, spec: dict, ratio: dict,
                   shape_seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(source, target) lengths: targets are sources times a ratio from
    evenly spaced points of [min, max], paired by a permutation fixed by
    ``shape_seed`` (the mix's, not the run's)."""
    src = lengths(n, spec)
    r = ratio["min"] + (ratio["max"] - ratio["min"]) * (np.arange(n) + 0.5) / n
    r = r[np.random.default_rng(shape_seed).permutation(n)]
    tgt = np.clip(np.rint(src * r), spec["min"], spec["max"]).astype(np.int64)
    return src, tgt


def sentences(lens: np.ndarray, lang: int, vocab: int,
              rng: np.random.Generator) -> List[List[int]]:
    """Token-id rows of the given lengths: the language token, skewed
    ordinary ids, the separator."""
    total = int(np.sum(lens - 2))
    u = rng.random(total)
    words = (FIRST_WORD + np.floor((vocab - FIRST_WORD) * u ** 3)).astype(
        np.int64)
    out, i = [], 0
    for n in lens:
        k = int(n) - 2
        out.append([lang] + words[i:i + k].tolist() + [SEP])
        i += k
    return out


def interleaved(n: int) -> List[int]:
    """0 .. n-1 in bit-reversed order: every prefix of the sequence samples
    the range evenly, so the first batches of a pass of length-sorted
    batches (a traced window's) are short, long and middling alike."""
    bits = max(1, (n - 1).bit_length())
    order = sorted(range(n), key=lambda i: int(format(i, f"0{bits}b")[::-1],
                                               2))
    return order
