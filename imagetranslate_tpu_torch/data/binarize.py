"""Offline binarization of parallel and monolingual text and of documents
(port of imagetranslate_tpu/data/binarize.py).

The ``.mt`` artifact is a marshal list of (src_ids, dst_ids, src_lang_type,
dst_lang_type), length-filtered to [min_len, max_len] and sorted by target
length. The MASS artifact is a set of shards ``out.0, out.1, ...``, each a
marshal list of (ids, lang_type) sorted by length, a new shard every
``shard_size`` examples. The lang entries are language TYPE ids
(``TextProcessor.languages`` values), not token ids. The document artifact
(``write_doc_blocks``) is a directory of blocks ``0.pkl, 1.pkl, ...``, each a
marshal dict {global row number: (ids, lang_type)} of fixed-length rows, and
an ``info.txt`` header. Either package reads what the other wrote.

``packed=True`` writes each of these files as an ITR1 record file instead
(``data/recordio.py``: MT records of 4 fields, MASS and document records of
2, ids then language type); the loaders tell the two formats apart by the
magic.
"""

from __future__ import annotations

import glob
import marshal
import os
from typing import List, Optional, Tuple

from imagetranslate_tpu_torch.data.recordio import (
    PackedReader,
    PackedTupleView,
    PackedWriter,
    is_packed,
)
from imagetranslate_tpu_torch.text.processor import TextProcessor


def _dump(examples, path: str, packed: bool, n_fields: int):
    """A list of tuples of ``n_fields`` (id lists and ints) to ``path``:
    marshal, or ITR1 records."""
    if not packed:
        with open(path, "wb") as fw:
            marshal.dump(examples, fw)
        return
    with PackedWriter(path, n_fields) as w:
        for ex in examples:
            w.add(*ex)


def write_mt(tp: TextProcessor, output_file: str, src_txt_file: str,
             src_lang_token_id: int, dst_txt_file: Optional[str] = None,
             dst_lang_token_id: Optional[int] = None, min_len: int = 1,
             max_len: int = 175, shard_size: int = 6_000_000,
             packed: bool = False) -> int:
    """Parallel text (``dst_txt_file`` given) -> one ``.mt`` file;
    monolingual text -> MASS shards ``output_file.N``; ITR1 records with
    ``packed``. Returns the number of examples kept."""
    src_lang_type = tp.languages[tp.id2token(src_lang_token_id)]
    if dst_txt_file is None:
        return _write_mass(tp, output_file, src_txt_file, src_lang_token_id,
                           src_lang_type, min_len, max_len, shard_size,
                           packed)
    dst_lang_type = tp.languages[tp.id2token(dst_lang_token_id)]
    examples: List[Tuple] = []
    with open(src_txt_file) as s_fp, open(dst_txt_file) as d_fp:
        for src_line, dst_line in zip(s_fp, d_fp):
            if not src_line.strip() or not dst_line.strip():
                continue
            src_ids = tp.tokenize_one_sentence_with_langid(
                src_line.strip(), src_lang_token_id)
            dst_ids = tp.tokenize_one_sentence_with_langid(
                dst_line.strip(), dst_lang_token_id)
            if min_len <= len(src_ids) <= max_len and \
                    min_len <= len(dst_ids) <= max_len:
                examples.append((src_ids, dst_ids, src_lang_type,
                                 dst_lang_type))
    examples.sort(key=lambda e: len(e[1]))
    _dump(examples, output_file, packed, 4)
    return len(examples)


def _write_mass(tp, output_file, src_txt_file, lang_token_id, lang_type,
                min_len, max_len, shard_size, packed) -> int:
    part_num, total = 0, 0
    examples: List[Tuple] = []

    def flush():
        nonlocal examples, part_num
        examples.sort(key=lambda e: len(e[0]))
        _dump(examples, f"{output_file}.{part_num}", packed, 2)
        examples = []
        part_num += 1

    with open(src_txt_file) as s_fp:
        for line in s_fp:
            if not line.strip():
                continue
            ids = tp.tokenize_one_sentence_with_langid(line.strip(),
                                                       lang_token_id)
            if min_len <= len(ids) <= max_len:
                examples.append((ids, lang_type))
                total += 1
            if len(examples) >= shard_size:
                flush()
    if examples:
        flush()
    return total


def _load(path: str, scalar_fields):
    """A marshal file's object, or a sequence of tuples over an ITR1 file
    (id fields as int32 arrays, ``scalar_fields`` as ints)."""
    if is_packed(path):
        return PackedTupleView(PackedReader(path), scalar_fields)
    with open(path, "rb") as fr:
        return marshal.load(fr)


def load_mt(path: str):
    """A ``.mt`` file, marshal or ITR1 -> sequence of (src_ids, dst_ids,
    src_lang_type, dst_lang_type)."""
    return _load(path, (2, 3))


def load_mass(path_prefix: str) -> List[Tuple]:
    """Every shard ``path_prefix*`` in sorted order, marshal or ITR1 ->
    list of (ids, lang_type)."""
    examples: List[Tuple] = []
    for path in sorted(glob.glob(path_prefix + "*")):
        examples.extend(_load(path, (1,)))
    return examples


def write_doc_blocks(tp: TextProcessor, txt_file: str, cache_dir: str,
                     seq_len: int = 512, sen_block_size: int = 10_000,
                     packed: bool = False) -> int:
    """Documents (one a line) -> fixed ``seq_len`` rows, blindly split, in
    blocks of ``sen_block_size`` rows: ``{N}.pkl`` marshals a dict
    {global row number: (ids, lang_type)}, the language type taken from the
    document's first token (with ``packed``, ITR1 records (ids, lang_type)
    under the same names). The rows left at the end are always dumped, so a
    row count that is an exact multiple of the block size ends with an EMPTY
    block (the on-disk format of the original binarizer, kept byte for byte).
    ``info.txt`` holds "block size, rows, blocks", tab-separated. Returns
    the number of rows."""
    os.makedirs(cache_dir, exist_ok=True)

    def dump_block(examples, path):
        _dump(list(examples.values()) if packed else examples, path, packed,
              2)

    examples = {}
    line_num, file_count = 0, 0
    with open(txt_file) as fp:
        for doc in fp:
            if not doc.strip():
                continue
            rows = tp.tokenize_lines(doc.strip(), blind_split=True,
                                     split_len=seq_len)
            if len(rows) == 0:
                continue
            lang = (tp.languages[tp.id2token(int(rows[0][0]))]
                    if tp.languages else 0)
            for seq in rows:
                examples[line_num] = ([int(x) for x in seq], lang)
                line_num += 1
                if len(examples) >= sen_block_size:
                    dump_block(examples,
                               os.path.join(cache_dir, f"{file_count}.pkl"))
                    examples = {}
                    file_count += 1
    if line_num:
        dump_block(examples, os.path.join(cache_dir, f"{file_count}.pkl"))
        file_count += 1
    with open(os.path.join(cache_dir, "info.txt"), "w") as fw:
        fw.write(f"{sen_block_size}\t{line_num}\t{file_count}")
    return line_num
