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
an ``info.txt`` header. Either package reads what the other wrote. The packed
record format (``packed=True``, files that
start with the ITR1 magic) is not ported yet.
"""

from __future__ import annotations

import glob
import marshal
import os
from typing import List, Optional, Tuple

from imagetranslate_tpu_torch.text.processor import TextProcessor

_PACKED_MAGIC = b"ITR1"


def write_mt(tp: TextProcessor, output_file: str, src_txt_file: str,
             src_lang_token_id: int, dst_txt_file: Optional[str] = None,
             dst_lang_token_id: Optional[int] = None, min_len: int = 1,
             max_len: int = 175, shard_size: int = 6_000_000,
             packed: bool = False) -> int:
    """Parallel text (``dst_txt_file`` given) -> one ``.mt`` file;
    monolingual text -> MASS shards ``output_file.N``. Returns the number of
    examples kept."""
    if packed:
        raise NotImplementedError(
            "packed=True: the packed record format is not ported yet "
            "(ROADMAP module 15)")
    src_lang_type = tp.languages[tp.id2token(src_lang_token_id)]
    if dst_txt_file is None:
        return _write_mass(tp, output_file, src_txt_file, src_lang_token_id,
                           src_lang_type, min_len, max_len, shard_size)
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
    with open(output_file, "wb") as fw:
        marshal.dump(examples, fw)
    return len(examples)


def _write_mass(tp, output_file, src_txt_file, lang_token_id, lang_type,
                min_len, max_len, shard_size) -> int:
    part_num, total = 0, 0
    examples: List[Tuple] = []

    def flush():
        nonlocal examples, part_num
        examples.sort(key=lambda e: len(e[0]))
        with open(f"{output_file}.{part_num}", "wb") as fw:
            marshal.dump(examples, fw)
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


def _load_marshal(path: str):
    with open(path, "rb") as fr:
        if fr.read(len(_PACKED_MAGIC)) == _PACKED_MAGIC:
            raise NotImplementedError(
                f"{path} is a packed record file; that format is not ported "
                "yet (ROADMAP module 15)")
        fr.seek(0)
        return marshal.load(fr)


def load_mt(path: str):
    """A marshal ``.mt`` file -> list of (src_ids, dst_ids, src_lang_type,
    dst_lang_type)."""
    return _load_marshal(path)


def load_mass(path_prefix: str) -> List[Tuple]:
    """Every shard ``path_prefix*`` in sorted order -> list of
    (ids, lang_type)."""
    examples: List[Tuple] = []
    for path in sorted(glob.glob(path_prefix + "*")):
        examples.extend(_load_marshal(path))
    return examples


def write_doc_blocks(tp: TextProcessor, txt_file: str, cache_dir: str,
                     seq_len: int = 512, sen_block_size: int = 10_000,
                     packed: bool = False) -> int:
    """Documents (one a line) -> fixed ``seq_len`` rows, blindly split, in
    blocks of ``sen_block_size`` rows: ``{N}.pkl`` marshals a dict
    {global row number: (ids, lang_type)}, the language type taken from the
    document's first token. The rows left at the end are always dumped, so a
    row count that is an exact multiple of the block size ends with an EMPTY
    block (the on-disk format of the original binarizer, kept byte for byte).
    ``info.txt`` holds "block size, rows, blocks", tab-separated. Returns
    the number of rows."""
    if packed:
        raise NotImplementedError(
            "packed=True: the packed record format is not ported yet "
            "(ROADMAP module 15)")
    os.makedirs(cache_dir, exist_ok=True)

    def dump_block(examples, path):
        with open(path, "wb") as fw:
            marshal.dump(examples, fw)

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
