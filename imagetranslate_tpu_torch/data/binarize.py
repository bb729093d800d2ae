"""Offline binarization of parallel and monolingual text (port of the MT and
MASS parts of imagetranslate_tpu/data/binarize.py).

The ``.mt`` artifact is a marshal list of (src_ids, dst_ids, src_lang_type,
dst_lang_type), length-filtered to [min_len, max_len] and sorted by target
length. The MASS artifact is a set of shards ``out.0, out.1, ...``, each a
marshal list of (ids, lang_type) sorted by length, a new shard every
``shard_size`` examples. The lang entries are language TYPE ids
(``TextProcessor.languages`` values), not token ids. Either package reads
what the other wrote. The packed record format (``packed=True``, files that
start with the ITR1 magic) is not ported yet.
"""

from __future__ import annotations

import glob
import marshal
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
