"""Sequence packing for the MT training stream (port of
imagetranslate_tpu/data/packing.py: ``PackedMTBatch``, ``pack_mt_examples``,
``packing_efficiency``, ``PackedMTBatcher``).

The bucketed batchers (data/loader.py) pad every row to its bucket, so a batch
of short sentences spends much of its compute on pad positions. Packing lays
several examples end to end in each fixed-size row and tells them apart by
segment ids: attention keeps each token inside its own example (the segment
biases of models/transformer.py), positions restart per example, and the
loss mask drops the slots that would predict across a boundary. The packed
forward equals the unpacked one per token, so ``cli.train_mt --pack`` changes
only how many tokens a step carries.

The batches are the JAX package's, byte for byte: first-fit over the
examples in their order (the binarizer sorts them by length), one language
direction per row and per batch, every batch ``rows_per_batch`` rows (a tail
batch's extra rows have segment ids 0: out of attention and the loss), and
``shuffled(seed)`` orders them by ``random.Random(seed)``.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class PackedMTBatch:
    src: np.ndarray        # [N, S] int32 token ids (pad_id outside segments)
    src_seg: np.ndarray    # [N, S] int32 segment ids, 0 = padding
    src_pos: np.ndarray    # [N, S] int32 positions restarting per segment
    dst: np.ndarray        # [N, T]
    dst_seg: np.ndarray    # [N, T]
    dst_pos: np.ndarray    # [N, T]
    src_langs: np.ndarray  # [N] language type id (one direction per batch)
    dst_langs: np.ndarray  # [N]
    n_examples: int

    @property
    def n_tokens(self) -> int:
        return int((self.dst_seg > 0).sum())


def pack_mt_examples(
    examples: Sequence[Tuple],
    pad_id: int = 0,
    src_budget: int = 256,
    dst_budget: int = 256,
    rows_per_batch: int = 64,
    max_seq_len: int = 175,
) -> List[PackedMTBatch]:
    """examples: (src_ids, dst_ids, src_lang_type, dst_lang_type), in the
    binarizer's length order. A row closes when the next example would
    overflow either budget or changes direction; rows group into batches per
    direction, in the order each direction first appears."""
    rows_by_dir: Dict[Tuple, List[List[Tuple]]] = {}
    cur: List[Tuple] = []
    cur_s = cur_d = 0
    cur_dir = None
    for ex in examples:
        src, dst = list(ex[0][:max_seq_len]), list(ex[1][:max_seq_len])
        direction = (ex[2], ex[3])
        if (cur and (cur_s + len(src) > src_budget
                     or cur_d + len(dst) > dst_budget
                     or direction != cur_dir)):
            rows_by_dir.setdefault(cur_dir, []).append(cur)
            cur, cur_s, cur_d = [], 0, 0
        cur.append((src, dst, ex[2], ex[3]))
        cur_s += len(src)
        cur_d += len(dst)
        cur_dir = direction
    if cur:
        rows_by_dir.setdefault(cur_dir, []).append(cur)

    groups = []
    for rows in rows_by_dir.values():
        for start in range(0, len(rows), rows_per_batch):
            groups.append(rows[start:start + rows_per_batch])

    batches: List[PackedMTBatch] = []
    for group in groups:
        N = max(rows_per_batch, len(group))
        src = np.full((N, src_budget), pad_id, np.int32)
        dst = np.full((N, dst_budget), pad_id, np.int32)
        src_seg = np.zeros((N, src_budget), np.int32)
        dst_seg = np.zeros((N, dst_budget), np.int32)
        src_pos = np.zeros((N, src_budget), np.int32)
        dst_pos = np.zeros((N, dst_budget), np.int32)
        n_ex = 0
        for r, row in enumerate(group):
            so = do = 0
            for seg_id, (s, d, _, _) in enumerate(row, start=1):
                src[r, so:so + len(s)] = s
                src_seg[r, so:so + len(s)] = seg_id
                src_pos[r, so:so + len(s)] = np.arange(len(s))
                dst[r, do:do + len(d)] = d
                dst_seg[r, do:do + len(d)] = seg_id
                dst_pos[r, do:do + len(d)] = np.arange(len(d))
                so += len(s)
                do += len(d)
                n_ex += 1
        direction = group[0][0][2], group[0][0][3]
        batches.append(PackedMTBatch(
            src=src, src_seg=src_seg, src_pos=src_pos,
            dst=dst, dst_seg=dst_seg, dst_pos=dst_pos,
            src_langs=np.full((N,), direction[0], np.int32),
            dst_langs=np.full((N,), direction[1], np.int32),
            n_examples=n_ex))
    return batches


def packing_efficiency(batches: Sequence[PackedMTBatch]) -> float:
    """Share of the target slots that carry real tokens (1.0: no padding)."""
    used = sum(int((b.dst_seg > 0).sum()) for b in batches)
    total = sum(b.dst_seg.size for b in batches)
    return used / max(total, 1)


class PackedMTBatcher:
    """Iterable over ``PackedMTBatch``, with ``MTBatcher``'s ``shuffled``,
    so that ``MTTrainer.train_epoch`` takes it as its mt stream."""

    def __init__(self, examples: Sequence[Tuple], pad_id: int = 0,
                 src_budget: int = 256, dst_budget: int = 256,
                 rows_per_batch: int = 64, max_seq_len: int = 175):
        self.batches = pack_mt_examples(
            examples, pad_id=pad_id, src_budget=src_budget,
            dst_budget=dst_budget, rows_per_batch=rows_per_batch,
            max_seq_len=max_seq_len)

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)

    def shuffled(self, seed: int):
        order = list(range(len(self.batches)))
        random.Random(seed).shuffle(order)
        return iter([self.batches[i] for i in order])
