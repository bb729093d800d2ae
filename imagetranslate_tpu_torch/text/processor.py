"""TextProcessor — the tokenizer facade of the MT and LM paths (port of
imagetranslate_tpu/text/processor.py).

Same artifact directory (``vocab.json`` + ``merges.txt`` + a pickled
``langs`` dict ``{"<en>": 0, ...}``), the same special tokens in id order
(<pad> <s> <unk> <mask> </s>, then one token per language; so pad is 0), and
the same sentence layout ``[<lang>] ids... </s>`` cut at 512. Document-level
tokenization (``tokenize_one_line``, ``tokenize_lines``, ``split_tokenized``)
serves the LM binarizer: a document's sentences, each with the language token
repeated, cut blindly into fixed rows or at sentence boundaries. A loaded
tokenizer encodes in C++ where ``text/native.py`` builds (the same ids).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from imagetranslate_tpu_torch.text.bpe import BPE, train_bpe
from imagetranslate_tpu_torch.text.native import NativeBPE

SPECIALS_BASE = ["<pad>", "<s>", "<unk>", "<mask>", "</s>"]
MAX_LEN = 512


class TextProcessor:
    def __init__(self, tok_model_path: Optional[str] = None):
        self.languages: Dict[str, int] = {}
        self.tokenizer: Optional[BPE] = None
        if tok_model_path is not None:
            self.tokenizer = BPE.load(tok_model_path)
            with open(os.path.join(tok_model_path, "langs"), "rb") as fp:
                self.languages = pickle.load(fp)
            native = NativeBPE(self.tokenizer)    # the C++ encode, if built
            if native.ok:
                self.tokenizer = native

    @property
    def special_tokens(self) -> List[str]:
        return SPECIALS_BASE + list(self.languages)

    def train_tokenizer(self, paths: List[str], vocab_size: int,
                        to_save_dir: str, languages: Dict[str, int]):
        self.languages = languages
        self.tokenizer = train_bpe(paths, vocab_size,
                                   special_tokens=self.special_tokens,
                                   min_frequency=5)
        self.tokenizer.save(to_save_dir)
        with open(os.path.join(to_save_dir, "langs"), "wb") as fp:
            pickle.dump(self.languages, fp)

    def tokenize_one_sentence(self, line: str) -> List[int]:
        """'<lang> text </s>' -> [lang_id, ids..., sep_id][:512]."""
        spl = line.strip().split(" ")
        lang, sen, eos = spl[0], " ".join(spl[1:-1]), spl[-1]
        ids = ([self.token_id(lang)] + self.tokenizer.encode(sen)
               + [self.token_id(eos)])
        return ids[:MAX_LEN]

    def tokenize_one_sentence_with_langid(self, line: str,
                                          lang_id: int) -> List[int]:
        """text -> [lang_id, ids..., sep_id][:512] (the binarizer's form)."""
        ids = [lang_id] + self.tokenizer.encode(line) + [self.sep_token_id()]
        return ids[:MAX_LEN]

    def tokenize_one_line(self, line: str,
                          ignore_middle_eos: bool = False) -> List[int]:
        """A line of several sentences separated by '</s>', with an optional
        leading '<lang>': its ids, a separator after every sentence (or one
        at the end only)."""
        ids: List[int] = []
        spl = [sen for sen in line.split("</s>") if len(sen.strip()) > 0]
        if spl and spl[0].startswith("<"):
            words = spl[0].strip().split(" ")
            spl[0] = " ".join(words[1:])
            ids.append(self.token_id(words[0]))
        for sen in spl:
            ids += self.tokenizer.encode(sen)
            if not ignore_middle_eos:
                ids.append(self.sep_token_id())
        if ignore_middle_eos:
            ids.append(self.sep_token_id())
        return ids

    def tokenize_lines(self, line: str, blind_split: bool = False,
                       split_len: int = 512):
        """A document -> rows of ids. The language token is repeated before
        every sentence. ``blind_split``: an int array [n, split_len], the
        last row padded (``-n % split_len`` pads: a document of an exact
        multiple of split_len tokens gets no all-pad row). Otherwise rows cut
        at sentence boundaries by ``split_tokenized``, as wide as the longest
        sentence."""
        ids: List[int] = []
        max_len = 0
        if len(self.languages) > 0:
            spl = [sen for sen in line.split("</s>") if len(sen.strip()) > 0]
            lang_prefix: List[int] = []
            if spl and spl[0].startswith("<"):
                words = spl[0].strip().split(" ")
                lang_prefix = [self.token_id(words[0])]
                spl[0] = " ".join(words[1:])
            for sen in spl:
                toks = self.tokenizer.encode(sen)
                ids += lang_prefix + toks + [self.sep_token_id()]
                max_len = max(max_len, len(toks) + 1)
        else:
            ids = self.tokenizer.encode(line.strip())
        if blind_split:
            num_pads = -len(ids) % split_len
            arr = np.array(ids + [self.pad_token_id()] * num_pads)
            return arr.reshape((-1, split_len))
        return self.split_tokenized(ids, min(max_len, MAX_LEN))

    def split_tokenized(self, tokenized: List[int],
                        max_length: int = 512) -> List[List[int]]:
        """Re-chunk a tokenized document at '</s>' boundaries, repeating the
        language token per chunk; the last chunk is padded to max_length."""
        if max_length < 2:
            # Chunks of no tokens would never consume the document (what
            # ``tokenize_lines`` without languages and without blind_split
            # asks for: it measures no sentence).
            raise ValueError(f"split_tokenized needs max_length >= 2, got "
                             f"{max_length}")
        pad = self.pad_token_id()
        if len(tokenized) <= max_length:
            return [tokenized + (max_length - len(tokenized)) * [pad]]

        has_lang = self.is_lang(tokenized[0])
        seq_len = len(tokenized)
        sep_id = self.sep_token_id()
        max_len = max_length - 1 if has_lang else max_length

        cur_start = 0
        sequences: List[List[int]] = []
        built_len = 0
        truncated = False
        used_ends = set()
        while cur_start < seq_len:
            if not truncated or not has_lang:
                cur_end = min(seq_len, cur_start + max_len)
            else:
                cur_end = min(seq_len, cur_start + max_len + 1)
            subseq = tokenized[cur_start:cur_end]

            built_len += len(subseq)
            # The running pointer goes back to the last new sentence end.
            sep_positions = [i for i in range(built_len)
                             if tokenized[i] == sep_id]
            if sep_positions:
                if sep_positions[-1] in used_ends:
                    truncated = True
                else:
                    built_len = sep_positions[-1] + 1
                    truncated = False
            else:
                truncated = True

            if has_lang and len(subseq) < max_len + 1:
                subseq = [tokenized[0]] + subseq
            sequences.append(subseq)
            cur_start = built_len
            used_ends.add(cur_start - 1)

        if len(sequences[-1]) < max_length:
            sequences[-1] = sequences[-1] + \
                (max_length - len(sequences[-1])) * [pad]
        return sequences

    def decode(self, ids: Sequence[int], skip_special: bool = False) -> str:
        skip = ({self.token_id(t) for t in self.special_tokens}
                if skip_special else None)
        return self.tokenizer.decode(ids, skip_special=skip)

    def token_id(self, token: str) -> int:
        tid = self.tokenizer.token_to_id(token)
        return 0 if tid is None else tid

    def id2token(self, i: int) -> str:
        return self.tokenizer.id_to_tok.get(int(i))

    def lang_id(self, tok: str) -> int:
        """The language index of a ``<lang>`` token (0 when unknown)."""
        return self.languages.get(tok, 0)

    def pad_token_id(self) -> int:
        return self.tokenizer.token_to_id("<pad>")

    def mask_token_id(self) -> int:
        return self.tokenizer.token_to_id("<mask>")

    def sep_token_id(self) -> int:
        return self.tokenizer.token_to_id("</s>")

    def vocab_size(self) -> int:
        return self.tokenizer.get_vocab_size()

    def is_lang(self, i: int) -> bool:
        return self.id2token(i) in self.languages
