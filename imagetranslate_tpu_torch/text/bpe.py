"""SentencePiece-style BPE tokenizer (port of imagetranslate_tpu/text/bpe.py).

Reads and writes the same HF-compatible ``vocab.json`` + ``merges.txt``
artifacts and gives the same ids, so a tokenizer trained by either package
works in the other:

- normalization: NFKC;
- pre-tokenization: Metaspace — every space becomes U+2581 '▁', a '▁' is
  prefixed to the text, and the text splits into pieces each starting with
  '▁';
- model: greedy lowest-rank-first merges; each unknown character maps to its
  own <unk> (fuse_unk=False);
- decoding: concatenate the token strings, map '▁' back to space, strip the
  leading space.

The merge loop is the hot path: ``text/native.py`` runs the encode and the
training in C++ where ``g++`` builds it, with the same ids and merges as the
Python code here (``TextProcessor`` swaps the encoder in, ``train_bpe`` the
trainer).
"""

from __future__ import annotations

import json
import os
import unicodedata
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

METASPACE = "▁"


def normalize(text: str) -> str:
    return unicodedata.normalize("NFKC", text)


def metaspace_split(text: str) -> List[str]:
    """'hello world' -> ['▁hello', '▁world'] (add_prefix_space=True)."""
    text = text.replace(" ", METASPACE)
    if not text.startswith(METASPACE):
        text = METASPACE + text
    pieces = []
    start = 0
    for i in range(1, len(text)):
        if text[i] == METASPACE:
            pieces.append(text[start:i])
            start = i
    pieces.append(text[start:])
    return [p for p in pieces if p]


class BPE:
    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 unk_token: str = "<unk>"):
        self.vocab = dict(vocab)
        self.id_to_tok = {i: t for t, i in self.vocab.items()}
        # A merge whose result is not in the (size-capped) vocabulary is dead,
        # as in HF's BPE: applying it would form tokens without an id.
        self.ranks = {pair: r for r, pair in enumerate(merges)
                      if pair[0] + pair[1] in self.vocab}
        self.merges = list(merges)
        self.unk_token = unk_token
        self.unk_id = self.vocab.get(unk_token)
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def load(cls, directory: str, unk_token: str = "<unk>") -> "BPE":
        with open(os.path.join(directory, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(os.path.join(directory, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, sep, b = line.partition(" ")
                if sep:
                    merges.append((a, b))
        return cls(vocab, merges, unk_token)

    def save(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "vocab.json"), "w",
                  encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False)
        with open(os.path.join(directory, "merges.txt"), "w",
                  encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for a, b in self.merges:
                f.write(f"{a} {b}\n")

    def _merge_word(self, word: str) -> List[str]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        parts = list(word)
        while len(parts) > 1:
            ranked = [(self.ranks.get((parts[i], parts[i + 1])), i)
                      for i in range(len(parts) - 1)]
            ranked = [(r, i) for r, i in ranked if r is not None]
            if not ranked:
                break
            _, best_i = min(ranked)
            a, b = parts[best_i], parts[best_i + 1]
            # The winning pair merges at every occurrence, left to right.
            out = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and parts[i] == a and parts[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        if len(self._cache) < 1_000_000:
            self._cache[word] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in metaspace_split(normalize(text)):
            for tok in self._merge_word(piece):
                tid = self.vocab.get(tok)
                if tid is not None:
                    ids.append(tid)
                    continue
                # An unknown piece: known characters keep their ids, each
                # unknown character becomes its own <unk>.
                for ch in tok:
                    cid = self.vocab.get(ch, self.unk_id)
                    if cid is not None:
                        ids.append(cid)
        return ids

    def decode(self, ids: Iterable[int],
               skip_special: Optional[set] = None) -> str:
        toks = [self.id_to_tok.get(int(i), self.unk_token or "")
                for i in ids if not (skip_special and int(i) in skip_special)]
        return "".join(toks).replace(METASPACE, " ").lstrip(" ")

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    def get_vocab_size(self) -> int:
        return len(self.vocab)


def train_bpe(files: Sequence[str], vocab_size: int,
              special_tokens: Sequence[str], min_frequency: int = 5,
              limit_alphabet: int = 1000, use_native: bool = True) -> BPE:
    """BPE trainer with SentencePieceBPETokenizer.train's defaults. The
    vocabulary holds the special tokens first (ids 0..n-1), then the
    single-character alphabet, then one entry per learned merge. Each round
    merges the most frequent pair; equal counts go to the smallest pair, the
    JAX package's rule, so both packages train the same artifact."""
    word_counts: Counter = Counter()
    for path in files:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = normalize(line.rstrip("\n"))
                if line:
                    word_counts.update(metaspace_split(line))

    char_counts: Counter = Counter()
    for word, c in word_counts.items():
        for ch in word:
            char_counts[ch] += c
    alphabet = sorted(ch for ch, _ in char_counts.most_common(limit_alphabet))

    vocab: Dict[str, int] = {}
    for tok in list(special_tokens) + alphabet:
        if tok not in vocab:
            vocab[tok] = len(vocab)

    alpha_set = set(alphabet)
    words: List[Tuple[List[str], int]] = []
    filtered_counts: Dict[str, int] = {}
    for word, c in word_counts.items():
        syms = [ch for ch in word if ch in alpha_set]
        if syms:
            words.append((syms, c))
            # Summed: two words may filter to one symbol string.
            key = "".join(syms)
            filtered_counts[key] = filtered_counts.get(key, 0) + c

    max_merges = max(0, vocab_size - len(vocab))
    # The C trainer hands each merge back as "a<TAB>b": words that hold a tab
    # take the Python trainer, which learns the same merges.
    if use_native and max_merges > 0 and not any(
            "\t" in word for word in filtered_counts):
        from imagetranslate_tpu_torch.text.native import train_merges_native

        native_merges = train_merges_native(filtered_counts, max_merges,
                                            min_frequency)
        if native_merges is not None:
            for a, b in native_merges:
                if a + b not in vocab:
                    vocab[a + b] = len(vocab)
            return BPE(vocab, native_merges)

    pair_counts: Counter = Counter()
    where: defaultdict = defaultdict(set)
    for wi, (syms, c) in enumerate(words):
        for i in range(len(syms) - 1):
            pair_counts[(syms[i], syms[i + 1])] += c
            where[(syms[i], syms[i + 1])].add(wi)

    def shift(pair, c, wi=None):
        pair_counts[pair] += c
        if pair_counts[pair] <= 0:
            del pair_counts[pair]
        elif wi is not None:
            where[pair].add(wi)

    merges: List[Tuple[str, str]] = []
    while len(vocab) < vocab_size and pair_counts:
        best_c = max(pair_counts.values())
        if best_c < min_frequency:
            break
        best = min(p for p, c in pair_counts.items() if c == best_c)
        merged = best[0] + best[1]
        merges.append(best)
        if merged not in vocab:
            vocab[merged] = len(vocab)
        for wi in list(where[best]):
            syms, c = words[wi]
            i = 0
            while i < len(syms) - 1:
                if syms[i] != best[0] or syms[i + 1] != best[1]:
                    i += 1
                    continue
                if i > 0:
                    shift((syms[i - 1], syms[i]), -c)
                if i < len(syms) - 2:
                    shift((syms[i + 1], syms[i + 2]), -c)
                syms[i:i + 2] = [merged]
                if i > 0:
                    shift((syms[i - 1], syms[i]), c, wi)
                if i < len(syms) - 1:
                    shift((syms[i], syms[i + 1]), c, wi)
        pair_counts.pop(best, None)
        where.pop(best, None)
    return BPE(vocab, merges)
