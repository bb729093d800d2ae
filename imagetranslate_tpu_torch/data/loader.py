"""Length-bucketed, fixed-shape host batching for translation and MASS, and
block-cached document rows for the LMs (port of ``MTBatcher``,
``MassBatcher``, ``DocBlockDataset`` and the lexical dictionary of
imagetranslate_tpu/data/loader.py).

Sequence lengths round up to a bucket multiple and row counts are a
deterministic function of the bucketed shape, under the reference's budget:

    rows <= max_batch // (sb + db)
    rows <= capacity*1e6 // ((sb^2 + db^2) * db)

A short batch pads with copies of its first row, masked by ``row_mask``.
The batches are those of the JAX package, so both decode the same rows in the
same order.
"""

from __future__ import annotations

import dataclasses
import marshal
import os
import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

ROW_QUANTUM = 8


def bucket_len(n: int, step: int = 16, minimum: int = 32) -> int:
    return max(minimum, ((n + step - 1) // step) * step)


def get_lex_dict(dict_path: str) -> Dict[int, List[int]]:
    """The ``--dict`` lexical dictionary: lines of "src_id cand1 cand2 ..."
    token ids."""
    lex: Dict[int, List[int]] = {}
    with open(dict_path) as dr:
        for line in dr:
            ids = [int(x) for x in line.strip().split(" ") if x]
            if len(ids) >= 2:
                lex.setdefault(ids[0], []).extend(ids[1:])
    return lex


def lex_proposals(ids: Sequence[int], lex_dict, pad_id: int) -> List[int]:
    """The sorted candidate set of one source row ([pad_id] if empty)."""
    out = sorted({c for t in ids for c in lex_dict.get(int(t), ())})
    return out if out else [pad_id]


def pack_proposals(rows: List[List[int]], pad_id: int,
                   step: int = 16) -> np.ndarray:
    width = bucket_len(max(len(r) for r in rows), step)
    arr = np.full((len(rows), width), pad_id, np.int32)
    for i, r in enumerate(rows):
        arr[i, :min(len(r), width)] = r[:width]
    return arr


def _capacity_rows(sb: int, db: int, capacity_mb: int) -> int:
    return int(capacity_mb * 1_000_000) // ((sb * sb + db * db) * db)


def _rows_for(sb: int, db: int, max_batch: int, capacity_mb: int) -> int:
    rows = max(1, min(max_batch // (sb + db),
                      _capacity_rows(sb, db, capacity_mb)))
    if rows > ROW_QUANTUM:
        rows = (rows // ROW_QUANTUM) * ROW_QUANTUM
    return rows


def _batch_rows(n_real: int, sb: int, db: int, max_batch: int,
                capacity_mb: int) -> int:
    """Rows of a batch holding n_real real rows: the bucket's budget rounded
    up to the 8-row quantum, unless the memory guard forbids the padding;
    never fewer than n_real."""
    cap = _rows_for(sb, db, max_batch, capacity_mb)
    target = -(-cap // ROW_QUANTUM) * ROW_QUANTUM
    if target > _capacity_rows(sb, db, capacity_mb):
        target = cap
    return max(target, n_real)


@dataclasses.dataclass
class MTBatch:
    src: np.ndarray        # [N, sb] int32
    src_mask: np.ndarray   # [N, sb] bool
    dst: np.ndarray        # [N, db] int32
    dst_mask: np.ndarray   # [N, db] bool
    src_langs: np.ndarray  # [N] language type ids
    dst_langs: np.ndarray  # [N]
    src_sizes: np.ndarray  # [N] true source lengths
    row_mask: np.ndarray   # [N] bool, False for padding rows
    proposals: Optional[np.ndarray] = None       # [N, P] --dict candidates
    proposal_mask: Optional[np.ndarray] = None   # [N, P]


class MTBatcher:
    """examples: (src_ids, dst_ids, src_lang_type, dst_lang_type) tuples in
    order; consecutive examples share a batch while their bucketed shape and
    the row budget allow."""

    def __init__(self, examples: Sequence[Tuple], pad_id: int = 0,
                 max_batch: int = 4000, capacity_mb: int = 600,
                 max_seq_len: int = 175, bucket_step: int = 16,
                 lex_dict=None):
        self.pad_id = pad_id
        self.lex_dict = lex_dict
        self.batches: List[MTBatch] = []
        cur: List[Tuple] = []
        cur_sb = cur_db = 0
        for ex in examples:
            src, dst = ex[0][:max_seq_len], ex[1][:max_seq_len]
            sb = bucket_len(len(src), bucket_step)
            db = bucket_len(len(dst), bucket_step)
            nsb, ndb = max(cur_sb, sb), max(cur_db, db)
            if cur and (nsb != cur_sb or ndb != cur_db or len(cur) + 1 >
                        _rows_for(nsb, ndb, max_batch, capacity_mb)):
                self._flush(cur, cur_sb, cur_db, max_batch, capacity_mb)
                cur, nsb, ndb = [], sb, db
            cur.append((src, dst, ex[2], ex[3]))
            cur_sb, cur_db = nsb, ndb
        if cur:
            self._flush(cur, cur_sb, cur_db, max_batch, capacity_mb)

    def _flush(self, rows_data, sb, db, max_batch, capacity_mb):
        n = len(rows_data)
        rows = _batch_rows(n, sb, db, max_batch, capacity_mb)
        src = np.full((rows, sb), self.pad_id, np.int32)
        dst = np.full((rows, db), self.pad_id, np.int32)
        src_langs = np.zeros((rows,), np.int32)
        dst_langs = np.zeros((rows,), np.int32)
        src_sizes = np.ones((rows,), np.int32)
        row_mask = np.zeros((rows,), bool)
        for i, (s, d, sl, dl) in enumerate(rows_data):
            src[i, :len(s)] = s
            dst[i, :len(d)] = d
            src_langs[i], dst_langs[i] = sl, dl
            src_sizes[i] = len(s)
            row_mask[i] = True
        # Padding rows copy row 0, so no row is wholly empty.
        src[n:], dst[n:] = src[0], dst[0]
        src_langs[n:], dst_langs[n:] = src_langs[0], dst_langs[0]
        src_sizes[n:] = src_sizes[0]
        proposals = proposal_mask = None
        if self.lex_dict is not None:
            proposals = pack_proposals(
                [lex_proposals(src[i], self.lex_dict, self.pad_id)
                 for i in range(rows)], self.pad_id)
            proposal_mask = proposals != self.pad_id
        self.batches.append(MTBatch(
            src, src != self.pad_id, dst, dst != self.pad_id, src_langs,
            dst_langs, src_sizes, row_mask, proposals, proposal_mask))

    def __len__(self):
        return len(self.batches)

    def __iter__(self) -> Iterator[MTBatch]:
        return iter(self.batches)

    def shuffled(self, seed: int) -> Iterator[MTBatch]:
        """The batches in the order ``random.Random(seed)`` shuffles them
        into (the JAX batcher's order for the same seed)."""
        order = list(range(len(self.batches)))
        random.Random(seed).shuffle(order)
        for i in order:
            yield self.batches[i]


@dataclasses.dataclass
class MassBatch:
    src: np.ndarray          # [N, S] int32
    src_mask: np.ndarray     # [N, S] bool
    langs: np.ndarray        # [N] language type ids
    lang_tokens: np.ndarray  # [N] the row's first token (language token id)
    lengths: np.ndarray      # [N] index of the first pad
    row_mask: np.ndarray     # [N] bool, False for padding rows


class MassBatcher:
    """Monolingual batches for MASS and back-translation. examples:
    (ids, lang_type) tuples, length-sorted; consecutive examples share a
    batch while their bucketed length and the row budget (the MT formula at
    sb = db = s) allow. Building batches from a packed record file
    (``from_packed``) is not ported."""

    def __init__(self, examples: Sequence[Tuple], pad_id: int = 0,
                 max_batch: int = 4000, capacity_mb: int = 600,
                 max_seq_len: int = 512, bucket_step: int = 16):
        self.pad_id = pad_id
        self.batches: List[MassBatch] = []
        cur: List[Tuple] = []
        cur_s = 0
        for ex in examples:
            if len(ex[0]) > max_seq_len:
                continue
            s = bucket_len(len(ex[0]), bucket_step)
            ns = max(cur_s, s)
            if cur and (ns != cur_s or len(cur) + 1 >
                        _rows_for(ns, ns, max_batch, capacity_mb)):
                self._flush(cur, cur_s, max_batch, capacity_mb)
                cur, ns = [], s
            cur.append(ex)
            cur_s = ns
        if cur:
            self._flush(cur, cur_s, max_batch, capacity_mb)

    def _flush(self, rows_data, s, max_batch, capacity_mb):
        n = len(rows_data)
        rows = _batch_rows(n, s, s, max_batch, capacity_mb)
        src = np.full((rows, s), self.pad_id, np.int32)
        langs = np.zeros((rows,), np.int32)
        lengths = np.ones((rows,), np.int32)
        row_mask = np.zeros((rows,), bool)
        for i, (ids, lang_type) in enumerate(rows_data):
            src[i, :len(ids)] = ids
            langs[i] = lang_type
            lengths[i] = len(ids)
            row_mask[i] = True
        # Padding rows copy row 0, so no row is wholly empty.
        src[n:], langs[n:], lengths[n:] = src[0], langs[0], lengths[0]
        self.batches.append(MassBatch(src, src != self.pad_id, langs,
                                      src[:, 0].copy(), lengths, row_mask))

    def __len__(self):
        return len(self.batches)

    def __iter__(self) -> Iterator[MassBatch]:
        return iter(self.batches)

    def shuffled(self, seed: int) -> Iterator[MassBatch]:
        """The batches in ``random.Random(seed)``'s order (the JAX batcher's
        for the same seed)."""
        order = list(range(len(self.batches)))
        random.Random(seed).shuffle(order)
        for i in order:
            yield self.batches[i]


class DocBlockDataset:
    """Block-cached random access over ``write_doc_blocks`` output: ``N.pkl``
    blocks and the ``info.txt`` header "block size, rows, blocks". Rows are
    fixed-length vectors, so batches have one shape.

    Reads the marshal dict {global row number: (ids, lang_type)} and the
    older marshal list of bare id rows (language type 0). A block in the
    packed record format (ITR1) is refused: not ported yet."""

    def __init__(self, cache_dir: str, max_cache_size: int = 100,
                 load_all: bool = False):
        self.cache_dir = cache_dir
        self.max_cache_size = max_cache_size
        with open(os.path.join(cache_dir, "info.txt")) as fr:
            spl = fr.read().strip().split("\t")
        self.sentence_block_size = int(spl[0])
        self.line_num = int(spl[1])
        self.file_count = int(spl[2])
        self.cache: Dict[int, list] = {}
        self._langs: Dict[int, list] = {}
        if load_all:
            self._fill(0, self.file_count)

    @staticmethod
    def _normalize(block):
        """-> (rows, langs). A dict block carries GLOBAL row numbers as keys;
        sorted keys give the block's own order, because consecutive numbers
        fill each block."""
        if isinstance(block, dict):
            block = [block[k] for k in sorted(block)]
        rows, langs = [], []
        for r in block:
            if (isinstance(r, (tuple, list)) and len(r) == 2
                    and isinstance(r[0], (list, tuple))):
                rows.append(list(r[0]))
                langs.append(int(r[1]))
            else:
                rows.append(list(r))
                langs.append(0)
        return rows, langs

    def _fill(self, start: int, end: int):
        self.cache = {}
        self._langs = {}
        for n in range(start, min(end, self.file_count)):
            path = os.path.join(self.cache_dir, f"{n}.pkl")
            with open(path, "rb") as fp:
                if fp.read(4) == b"ITR1":
                    raise NotImplementedError(
                        f"{path} is a packed record file; that format is "
                        "not ported yet (ROADMAP module 15)")
                fp.seek(0)
                block = marshal.load(fp)
            self.cache[n], self._langs[n] = self._normalize(block)

    def __len__(self):
        return self.line_num

    def _block(self, item: int) -> int:
        file_num = item // self.sentence_block_size
        if file_num not in self.cache:
            self._fill(file_num, file_num + self.max_cache_size)
        return file_num

    def __getitem__(self, item: int):
        block = self._block(item)      # may refill (replace) the cache
        return self.cache[block][item % self.sentence_block_size]

    def lang_at(self, item: int) -> int:
        """The language TYPE id stored with the row; 0 where the block
        carries none."""
        block = self._block(item)
        return self._langs[block][item % self.sentence_block_size]

    def batches(self, batch_rows: int, pad_id: int = 0, lang_of=None):
        """Fixed-shape [batch_rows, seq_len] batches as dicts of numpy arrays
        (texts, pad_mask, langs, row_mask); the last, partial batch fills up
        with copies of its first row, masked out by ``row_mask``. ``lang_of``:
        fn(row ids) -> language type id, in place of the stored one."""
        n = len(self)
        for start in range(0, n, batch_rows):
            idx = list(range(start, min(n, start + batch_rows)))
            rows = [self[i] for i in idx]
            real = len(rows)
            while len(rows) < batch_rows:
                rows.append(rows[0])
                idx.append(idx[0])
            texts = np.asarray(rows, np.int32)
            if lang_of is not None:
                langs = np.array([lang_of(r) for r in rows], np.int32)
            else:
                langs = np.array([self.lang_at(i) for i in idx], np.int32)
            row_mask = np.zeros((batch_rows,), bool)
            row_mask[:real] = True
            yield {"texts": texts, "pad_mask": texts != pad_id,
                   "langs": langs, "row_mask": row_mask}
