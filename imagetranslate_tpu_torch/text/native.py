"""The C++ BPE encoder and trainer (port of imagetranslate_tpu/text/native.py):
a ctypes binding of ``text/_native/bpe.cpp``, built by ``g++`` at first use
(``utils/native.py``).

``NativeBPE`` wraps a Python ``BPE``: its vocabulary and merge ranks are
pushed into the C++ engine once, ``encode`` runs there (the ids are the
Python encoder's), and everything else is the Python object's.
``train_merges_native`` learns the merges of ``train_bpe`` in C++.
"""

from __future__ import annotations

import ctypes
import os
from typing import List

from imagetranslate_tpu_torch.text.bpe import BPE, normalize
from imagetranslate_tpu_torch.utils import native

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native",
                   "bpe.cpp")


def _declare(lib):
    p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    lib.bpe_new.restype = p
    lib.bpe_free.argtypes = [p]
    lib.bpe_add_token.argtypes = [p, s, i]
    lib.bpe_add_merge.argtypes = [p, s, s, i]
    lib.bpe_set_unk.argtypes = [p, i]
    lib.bpe_encode.argtypes = [p, s, ctypes.POINTER(ctypes.c_int32), i]
    lib.bpe_encode.restype = i
    lib.bpe_trainer_new.restype = p
    lib.bpe_trainer_free.argtypes = [p]
    lib.bpe_trainer_add_words.argtypes = [p, s,
                                          ctypes.POINTER(ctypes.c_int64), i]
    lib.bpe_trainer_train.argtypes = [p, i, ctypes.c_int64]
    lib.bpe_trainer_train.restype = i
    lib.bpe_trainer_get_merge.argtypes = [p, i, s, i]
    lib.bpe_trainer_get_merge.restype = i


def get_lib():
    """The BPE library, or None where it cannot be built."""
    return native.load("bpe", SRC, declare=_declare)


def train_merges_native(word_counts, max_merges: int, min_frequency: int):
    """{word: count} -> the list of (a, b) merges, or None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.bpe_trainer_new()
    try:
        words = list(word_counts)
        counts = (ctypes.c_int64 * len(words))(*[word_counts[w]
                                                  for w in words])
        lib.bpe_trainer_add_words(h, "\n".join(words).encode("utf-8"),
                                  counts, len(words))
        n = lib.bpe_trainer_train(h, max_merges, min_frequency)
        buf = ctypes.create_string_buffer(4096)
        merges = []
        for i in range(n):
            if lib.bpe_trainer_get_merge(h, i, buf, 4096) < 0:
                continue
            a, b = buf.value.decode("utf-8").split("\t")
            merges.append((a, b))
        return merges
    finally:
        lib.bpe_trainer_free(h)


class NativeBPE:
    """``BPE`` with its encode in C++; ``ok`` is False without the library.
    Any other attribute is the wrapped Python object's."""

    MAX_OUT = 65536

    def __init__(self, pybpe: BPE):
        self.py = pybpe
        self.ok = False
        lib = get_lib()
        if lib is None:
            return
        self._lib = lib
        self._h = lib.bpe_new()
        for tok, tid in pybpe.vocab.items():
            lib.bpe_add_token(self._h, tok.encode("utf-8"), tid)
        for pair, rank in pybpe.ranks.items():
            lib.bpe_add_merge(self._h, pair[0].encode("utf-8"),
                              pair[1].encode("utf-8"), rank)
        if pybpe.unk_id is not None:
            lib.bpe_set_unk(self._h, pybpe.unk_id)
        self._buf = (ctypes.c_int32 * self.MAX_OUT)()
        self.ok = True

    def __getattr__(self, name):
        if name == "py":
            raise AttributeError(name)
        return getattr(self.py, name)

    def __del__(self):
        if self.__dict__.get("ok"):
            try:
                self._lib.bpe_free(self._h)
            except Exception:
                pass

    def encode(self, text: str) -> List[int]:
        data = normalize(text).encode("utf-8")
        n = self._lib.bpe_encode(self._h, data, self._buf, self.MAX_OUT)
        if n > self.MAX_OUT:
            # The full count came back: encode again into a buffer that
            # holds it rather than drop the tail of a very long line.
            big = (ctypes.c_int32 * n)()
            n = self._lib.bpe_encode(self._h, data, big, n)
            return list(big[:n])
        return list(self._buf[:n])
