"""TextProcessor — the tokenizer facade the MT paths need (port of the
sentence-level part of imagetranslate_tpu/text/processor.py).

Same artifact directory (``vocab.json`` + ``merges.txt`` + a pickled
``langs`` dict ``{"<en>": 0, ...}``), the same special tokens in id order
(<pad> <s> <unk> <mask> </s>, then one token per language; so pad is 0), and
the same sentence layout ``[<lang>] ids... </s>`` cut at 512. Document-level
tokenization (``tokenize_lines``, ``split_tokenized``) serves the LM
trainers and is not ported yet.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

from imagetranslate_tpu_torch.text.bpe import BPE, train_bpe

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

    def decode(self, ids: Sequence[int], skip_special: bool = False) -> str:
        skip = ({self.token_id(t) for t in self.special_tokens}
                if skip_special else None)
        return self.tokenizer.decode(ids, skip_special=skip)

    def token_id(self, token: str) -> int:
        tid = self.tokenizer.token_to_id(token)
        return 0 if tid is None else tid

    def id2token(self, i: int) -> str:
        return self.tokenizer.id_to_tok.get(int(i))

    def pad_token_id(self) -> int:
        return self.tokenizer.token_to_id("<pad>")

    def mask_token_id(self) -> int:
        return self.tokenizer.token_to_id("<mask>")

    def sep_token_id(self) -> int:
        return self.tokenizer.token_to_id("</s>")

    def vocab_size(self) -> int:
        return self.tokenizer.get_vocab_size()
