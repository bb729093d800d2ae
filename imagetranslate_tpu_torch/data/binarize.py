"""Offline binarization of parallel text (port of the MT part of
imagetranslate_tpu/data/binarize.py).

The ``.mt`` artifact is a marshal list of (src_ids, dst_ids, src_lang_type,
dst_lang_type), length-filtered to [min_len, max_len] and sorted by target
length; the lang entries are language TYPE ids (``TextProcessor.languages``
values), not token ids. Either package reads what the other wrote. The
packed record format (``packed=True``) and the monolingual (MASS) shards are
not ported yet.
"""

from __future__ import annotations

import marshal
from typing import List, Optional, Tuple

from imagetranslate_tpu_torch.text.processor import TextProcessor

_PACKED_MAGIC = b"ITR1"


def write_mt(tp: TextProcessor, output_file: str, src_txt_file: str,
             src_lang_token_id: int, dst_txt_file: Optional[str] = None,
             dst_lang_token_id: Optional[int] = None, min_len: int = 1,
             max_len: int = 175, packed: bool = False) -> int:
    """Parallel text -> one ``.mt`` file; returns the number of examples."""
    if packed:
        raise NotImplementedError(
            "packed=True: the packed record format is not ported yet "
            "(ROADMAP module 15)")
    if dst_txt_file is None:
        raise NotImplementedError(
            "monolingual mode writes MASS shards, which are not ported yet "
            "(ROADMAP module 8)")
    src_lang_type = tp.languages[tp.id2token(src_lang_token_id)]
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


def load_mt(path: str):
    """A marshal ``.mt`` file -> list of (src_ids, dst_ids, src_lang_type,
    dst_lang_type)."""
    with open(path, "rb") as fr:
        if fr.read(len(_PACKED_MAGIC)) == _PACKED_MAGIC:
            raise NotImplementedError(
                f"{path} is a packed record file; that format is not ported "
                "yet (ROADMAP module 15)")
        fr.seek(0)
        return marshal.load(fr)
