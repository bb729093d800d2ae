"""The tokenizer facade the program's trainer and CLIs read (special tokens,
the two language tokens, pad / mask / separator ids, ``decode``), over a
vocabulary whose ordinary tokens are their own ids, so that a cell runs at
the configuration's full vocabulary without training a BPE of that size.
``decode`` writes a row as its ids, which the checks read back."""

from __future__ import annotations


class StandInVocab:
    special_tokens = ["<pad>", "<s>", "<unk>", "<mask>", "</s>", "<aa>",
                      "<bb>"]
    languages = {"<aa>": 0, "<bb>": 1}

    def __init__(self, vocab_size: int, sep: int = 4):
        """``sep``: the separator id; -1 puts it outside the vocabulary, so
        that no decode ends early and every row runs to its limit."""
        self._size, self._sep = vocab_size, sep

    def token_id(self, token: str) -> int:
        return self.special_tokens.index(token)

    def id2token(self, i: int):
        i = int(i)
        return self.special_tokens[i] if i < len(self.special_tokens) else None

    def pad_token_id(self) -> int:
        return 0

    def mask_token_id(self) -> int:
        return 3

    def sep_token_id(self) -> int:
        return self._sep

    def vocab_size(self) -> int:
        return self._size

    def decode(self, ids) -> str:
        return " ".join(str(int(i)) for i in ids)
