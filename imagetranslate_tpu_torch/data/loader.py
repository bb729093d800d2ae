"""Length-bucketed, fixed-shape host batching for translation and MASS, and
block-cached document rows for the LMs (port of ``MTBatcher``,
``MassBatcher``, ``DocBlockDataset`` and the lexical dictionary of
imagetranslate_tpu/data/loader.py). ``from_packed`` builds the same batches
from an ITR1 file (``data/recordio.py``): the grouping reads only the length
arrays, and the rows are padded in C.

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

from imagetranslate_tpu_torch.data.recordio import PackedReader, is_packed

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


def _groups(ls, ld, max_batch: int, capacity_mb: int, bucket_step: int):
    """The batches of consecutive examples of source lengths ``ls`` and
    target lengths ``ld`` (None: skipped): (indices, sb, db) for each run
    that shares one bucketed shape within the row budget."""
    cur: List[int] = []
    cur_sb = cur_db = 0
    for i, (a, b) in enumerate(zip(ls, ld)):
        if a is None:
            continue
        sb, db = bucket_len(a, bucket_step), bucket_len(b, bucket_step)
        nsb, ndb = max(cur_sb, sb), max(cur_db, db)
        if cur and (nsb != cur_sb or ndb != cur_db or len(cur) + 1 >
                    _rows_for(nsb, ndb, max_batch, capacity_mb)):
            yield cur, cur_sb, cur_db
            cur, nsb, ndb = [], sb, db
        cur.append(i)
        cur_sb, cur_db = nsb, ndb
    if cur:
        yield cur, cur_sb, cur_db


class MTBatcher:
    """examples: (src_ids, dst_ids, src_lang_type, dst_lang_type) tuples in
    order; consecutive examples share a batch while their bucketed shape and
    the row budget allow. ``from_packed`` builds the same batches from an
    ITR1 file's reader."""

    def __init__(self, examples: Sequence[Tuple], pad_id: int = 0,
                 max_batch: int = 4000, capacity_mb: int = 600,
                 max_seq_len: int = 175, bucket_step: int = 16,
                 lex_dict=None):
        self.pad_id = pad_id
        self.lex_dict = lex_dict
        self.batches: List[MTBatch] = []
        examples = [(ex[0][:max_seq_len], ex[1][:max_seq_len], ex[2], ex[3])
                    for ex in examples]
        for idx, sb, db in _groups([len(ex[0]) for ex in examples],
                                   [len(ex[1]) for ex in examples],
                                   max_batch, capacity_mb, bucket_step):
            rows = _batch_rows(len(idx), sb, db, max_batch, capacity_mb)
            src = np.full((rows, sb), pad_id, np.int32)
            dst = np.full((rows, db), pad_id, np.int32)
            for r, i in enumerate(idx):
                s, d = examples[i][0], examples[i][1]
                src[r, :len(s)], dst[r, :len(d)] = s, d
            self._append(src, dst, [examples[i][2] for i in idx],
                         [examples[i][3] for i in idx],
                         [len(examples[i][0]) for i in idx])

    @classmethod
    def from_packed(cls, reader: PackedReader, pad_id: int = 0,
                    max_batch: int = 4000, capacity_mb: int = 600,
                    max_seq_len: int = 175, bucket_step: int = 16,
                    lex_dict=None) -> "MTBatcher":
        """The batches of ``MTBatcher(load_mt(path))`` from the ITR1 file's
        reader: the grouping reads the length arrays, and the rows of a
        batch are gathered and padded by ``reader.pack_padded``."""
        self = cls.__new__(cls)
        self.pad_id = pad_id
        self.lex_dict = lex_dict
        self.batches = []
        ls = np.minimum(reader.lengths(0), max_seq_len).astype(np.int32)
        ld = np.minimum(reader.lengths(1), max_seq_len).astype(np.int32)
        sl_all, dl_all = reader.scalars(2), reader.scalars(3)
        for idx, sb, db in _groups(ls.tolist(), ld.tolist(), max_batch,
                                   capacity_mb, bucket_step):
            n = len(idx)
            rows = _batch_rows(n, sb, db, max_batch, capacity_mb)
            ii = np.asarray(idx, np.int64)
            src = np.full((rows, sb), pad_id, np.int32)
            dst = np.full((rows, db), pad_id, np.int32)
            src[:n] = reader.pack_padded(ii, 0, sb, pad_id)
            dst[:n] = reader.pack_padded(ii, 1, db, pad_id)
            # The max_seq_len cut: the C gather cuts at the bucket's width.
            src[:n][np.arange(sb)[None, :] >= ls[ii][:, None]] = pad_id
            dst[:n][np.arange(db)[None, :] >= ld[ii][:, None]] = pad_id
            self._append(src, dst, sl_all[ii], dl_all[ii], ls[ii])
        return self

    def _append(self, src, dst, src_langs, dst_langs, src_sizes):
        """Close a batch whose first len(src_sizes) rows are real: padding
        rows copy row 0, so no row is wholly empty."""
        n, rows = len(src_sizes), src.shape[0]
        langs = np.zeros((2, rows), np.int32)
        sizes = np.ones((rows,), np.int32)
        langs[0, :n], langs[1, :n], sizes[:n] = src_langs, dst_langs, src_sizes
        src[n:], dst[n:], langs[:, n:], sizes[n:] = (src[0], dst[0],
                                                     langs[:, :1], sizes[0])
        proposals = proposal_mask = None
        if self.lex_dict is not None:
            proposals = pack_proposals(
                [lex_proposals(src[i], self.lex_dict, self.pad_id)
                 for i in range(rows)], self.pad_id)
            proposal_mask = proposals != self.pad_id
        self.batches.append(MTBatch(
            src, src != self.pad_id, dst, dst != self.pad_id, langs[0],
            langs[1], sizes, np.arange(rows) < n, proposals, proposal_mask))

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
    sb = db = s) allow, examples longer than ``max_seq_len`` left out;
    ``from_packed`` builds the same batches from an ITR1 shard."""

    def __init__(self, examples: Sequence[Tuple], pad_id: int = 0,
                 max_batch: int = 4000, capacity_mb: int = 600,
                 max_seq_len: int = 512, bucket_step: int = 16):
        self.pad_id = pad_id
        self.batches: List[MassBatch] = []
        lens = [len(ex[0]) if len(ex[0]) <= max_seq_len else None
                for ex in examples]
        for idx, s, _ in _groups(lens, lens, max_batch, capacity_mb,
                                 bucket_step):
            rows = _batch_rows(len(idx), s, s, max_batch, capacity_mb)
            src = np.full((rows, s), pad_id, np.int32)
            for r, i in enumerate(idx):
                src[r, :lens[i]] = examples[i][0]
            self._append(src, [examples[i][1] for i in idx],
                         [lens[i] for i in idx])

    @classmethod
    def from_packed(cls, reader: PackedReader, pad_id: int = 0,
                    max_batch: int = 4000, capacity_mb: int = 600,
                    max_seq_len: int = 512,
                    bucket_step: int = 16) -> "MassBatcher":
        """The batches of ``MassBatcher`` over an ITR1 shard's records, the
        rows padded by ``reader.pack_padded``."""
        self = cls.__new__(cls)
        self.pad_id = pad_id
        self.batches = []
        lens = reader.lengths(0).astype(np.int32)
        langs_all = reader.scalars(1)
        kept = [int(n) if n <= max_seq_len else None for n in lens]
        for idx, s, _ in _groups(kept, kept, max_batch, capacity_mb,
                                 bucket_step):
            rows = _batch_rows(len(idx), s, s, max_batch, capacity_mb)
            ii = np.asarray(idx, np.int64)
            src = np.full((rows, s), pad_id, np.int32)
            src[:len(idx)] = reader.pack_padded(ii, 0, s, pad_id)
            self._append(src, langs_all[ii], lens[ii])
        return self

    def _append(self, src, langs, lengths):
        """Close a batch whose first len(lengths) rows are real: padding
        rows copy row 0, so no row is wholly empty."""
        n, rows = len(lengths), src.shape[0]
        lang = np.zeros((rows,), np.int32)
        size = np.ones((rows,), np.int32)
        lang[:n], size[:n] = langs, lengths
        src[n:], lang[n:], size[n:] = src[0], lang[0], size[0]
        self.batches.append(MassBatch(src, src != self.pad_id, lang,
                                      src[:, 0].copy(), size,
                                      np.arange(rows) < n))

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

    Reads the marshal dict {global row number: (ids, lang_type)}, the older
    marshal list of bare id rows (language type 0) and ITR1 blocks (one
    field: ids, language type 0; two fields: ids and language type)."""

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
            if is_packed(path):
                r = PackedReader(path)
                self.cache[n] = [r.field(i, 0).tolist()
                                 for i in range(len(r))]
                self._langs[n] = (r.scalars(1).tolist() if r.n_fields >= 2
                                  else [0] * len(r))
                r.close()
                continue
            with open(path, "rb") as fp:
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
