"""The ITR1 packed record format (port of imagetranslate_tpu/data/recordio.py):
a ctypes binding of ``data/_native/recordio.cpp``, with a numpy path for a
host without a compiler.

ITR1 holds every record of a corpus in one flat file that is read through
mmap: a record's field lengths are read without deserializing anything, and
padded batches are assembled in C (``pack_padded``). Layout, little-endian:
the magic "ITR1", u32 F fields a record, u64 N records, u64 index[N*F + 1]
(cumulative int32 offsets into the data), then the int32 data; a scalar is a
field of length 1. Both packages write the same bytes and read each other's
files. The binarizers write marshal unless asked for ``packed``; the loaders
(``data/binarize.py``) read either, by the magic.

The C library is built by ``g++`` at first use (``utils/native.py``); where
that fails the numpy path below reads and writes the same files.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Sequence

import numpy as np

from imagetranslate_tpu_torch.utils import native

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native",
                   "recordio.cpp")
MAGIC = b"ITR1"


def _declare(lib):
    p, u64, u32 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.rec_writer_new.restype = p
    lib.rec_writer_new.argtypes = [ctypes.c_char_p, u64]
    lib.rec_writer_add_field.restype = ctypes.c_int
    lib.rec_writer_add_field.argtypes = [p, i32p, u64]
    lib.rec_writer_close.restype = ctypes.c_int
    lib.rec_writer_close.argtypes = [p]
    lib.rec_writer_abort.argtypes = [p]
    lib.rec_open.restype = p
    lib.rec_open.argtypes = [ctypes.c_char_p]
    lib.rec_close.argtypes = [p]
    lib.rec_count.restype = u64
    lib.rec_count.argtypes = [p]
    lib.rec_fields.restype = u32
    lib.rec_fields.argtypes = [p]
    lib.rec_field_len.restype = u64
    lib.rec_field_len.argtypes = [p, u64, u32]
    lib.rec_field_ptr.restype = i32p
    lib.rec_field_ptr.argtypes = [p, u64, u32]
    lib.rec_lens.argtypes = [p, u32, i64p]
    lib.rec_scalars.argtypes = [p, u32, i32p]
    lib.rec_pack_padded.argtypes = [p, i64p, ctypes.c_int64, u32,
                                    ctypes.c_int64, ctypes.c_int32, i32p]


def get_lib():
    """The record library, or None where it cannot be built."""
    return native.load("recordio", SRC, declare=_declare)


def _i32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def is_packed(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) == MAGIC
    except OSError:
        return False


class PackedWriter:
    """Streamed writer: each ``add`` takes exactly ``n_fields`` int arrays or
    ints. The data goes to ``path + ".data.tmp"`` and is copied behind the
    index at ``close``; leaving a ``with`` block on an exception removes the
    temporary file and writes nothing."""

    def __init__(self, path: str, n_fields: int):
        self.n_fields = n_fields
        self.path = path
        self._lib = get_lib()
        self._h = None
        if self._lib is not None:
            self._h = self._lib.rec_writer_new(path.encode(), n_fields)
            if not self._h:
                raise OSError(f"cannot open {path}")
        else:
            self._tmp = open(path + ".data.tmp", "wb")
            self._offsets: List[int] = [0]
            self._total = 0
        self._closed = False

    def add(self, *fields):
        assert len(fields) == self.n_fields
        for f in fields:
            arr = np.asarray([f] if np.isscalar(f) else f, np.int32)
            arr = np.ascontiguousarray(arr.reshape(-1))
            if self._h is not None:
                if self._lib.rec_writer_add_field(self._h, _i32p(arr),
                                                  arr.size) != 0:
                    raise OSError("recordio write failed")
            else:
                self._tmp.write(arr.tobytes())
                self._total += arr.size
                self._offsets.append(self._total)

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._h is not None:
            rc = self._lib.rec_writer_close(self._h)
            if rc != 0:
                raise OSError(f"recordio close failed ({rc})")
            return
        self._tmp.close()
        n_records = (len(self._offsets) - 1) // self.n_fields
        tmp_path = self.path + ".data.tmp"
        with open(self.path, "wb") as out:
            out.write(MAGIC)
            out.write(np.uint32(self.n_fields).tobytes())
            out.write(np.uint64(n_records).tobytes())
            out.write(np.asarray(self._offsets, np.uint64).tobytes())
            with open(tmp_path, "rb") as tmp:
                while True:
                    chunk = tmp.read(1 << 20)
                    if not chunk:
                        break
                    out.write(chunk)
        os.remove(tmp_path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        elif not self._closed:
            self._closed = True
            if self._h is not None:
                self._lib.rec_writer_abort(self._h)
            else:
                self._tmp.close()
                os.remove(self.path + ".data.tmp")


class PackedReader:
    """Random access through mmap. Opening checks the header and the whole
    offset index against the file's size: a truncated or corrupt file raises
    OSError here, never an IndexError or a crash mid-epoch."""

    def __init__(self, path: str):
        self.path = path
        self._lib = get_lib()
        self._h = None
        self._mm = None
        if self._lib is not None:
            self._h = self._lib.rec_open(path.encode())
            if not self._h:
                raise OSError(f"not an ITR1 file: {path}")
            self.n_records = int(self._lib.rec_count(self._h))
            self.n_fields = int(self._lib.rec_fields(self._h))
            return
        self._mm = np.memmap(path, np.uint8, "r")
        # The native reader's order of checks: the size before the header.
        size = self._mm.size
        if size < 16 or bytes(self._mm[:4].tobytes()) != MAGIC:
            raise OSError(f"not an ITR1 file: {path}")
        self.n_fields = int(self._mm[4:8].view(np.uint32)[0])
        self.n_records = int(self._mm[8:16].view(np.uint64)[0])
        if self.n_fields <= 0:
            raise OSError(f"corrupt ITR1 header: {path}")
        max_fields = (size - 16) // 8
        if max_fields < 1 or \
                self.n_records > (max_fields - 1) // self.n_fields:
            raise OSError(f"corrupt ITR1 (index exceeds file): {path}")
        n_idx = self.n_records * self.n_fields + 1
        self._index = self._mm[16:16 + 8 * n_idx].view(np.uint64)
        data_elems = (size - 16 - 8 * n_idx) // 4
        if int(self._index[0]) != 0 or \
                int(self._index[-1]) > data_elems or \
                bool(np.any(np.diff(self._index.astype(np.int64)) < 0)):
            raise OSError(f"corrupt ITR1 (bad offset index): {path}")
        self._data = self._mm[16 + 8 * n_idx:].view(np.int32)

    @property
    def native(self) -> bool:
        """Does this reader go through the C library?"""
        return self._h is not None

    def __len__(self):
        return self.n_records

    def field_len(self, i: int, f: int) -> int:
        if self._h is not None:
            return int(self._lib.rec_field_len(self._h, i, f))
        k = i * self.n_fields + f
        return int(self._index[k + 1] - self._index[k])

    def field(self, i: int, f: int) -> np.ndarray:
        """An owned copy of field f of record i: it outlives the reader
        (a view into the unmapped file would not)."""
        return np.array(self.field_view(i, f))

    def field_view(self, i: int, f: int) -> np.ndarray:
        """A view into the mapping, valid only while this reader lives."""
        n = self.field_len(i, f)
        if self._h is not None:
            if n == 0:
                return np.empty((0,), np.int32)
            ptr = self._lib.rec_field_ptr(self._h, i, f)
            return np.ctypeslib.as_array(ptr, (n,))
        o = int(self._index[i * self.n_fields + f])
        return self._data[o:o + n]

    def lengths(self, f: int) -> np.ndarray:
        """Every record's length of field f, int64 [N]."""
        out = np.empty((self.n_records,), np.int64)
        if self._h is not None:
            self._lib.rec_lens(
                self._h, f, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            return out
        k = np.arange(self.n_records) * self.n_fields + f
        return (self._index[k + 1].astype(np.int64)
                - self._index[k].astype(np.int64))

    def scalars(self, f: int) -> np.ndarray:
        """Every record's value of the scalar field f, int32 [N]."""
        out = np.empty((self.n_records,), np.int32)
        if self._h is not None:
            self._lib.rec_scalars(self._h, f, _i32p(out))
            return out
        for i in range(self.n_records):
            out[i] = self.field(i, f)[0]
        return out

    def pack_padded(self, indices: Sequence[int], f: int, width: int,
                    pad: int) -> np.ndarray:
        """Field f of the records ``indices`` as a [len(indices), width]
        int32 matrix, cut at ``width`` and padded with ``pad``."""
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        out = np.empty((idx.size, width), np.int32)
        if self._h is not None:
            self._lib.rec_pack_padded(
                self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                idx.size, f, width, pad, _i32p(out))
            return out
        out.fill(pad)
        for r, i in enumerate(idx):
            v = self.field_view(int(i), f)[:width]
            out[r, :v.size] = v
        return out

    def close(self):
        if self._h is not None:
            self._lib.rec_close(self._h)
            self._h = None
        self._mm = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PackedTupleView:
    """A sequence over a PackedReader: record i -> the tuple of its fields,
    the fields in ``scalar_fields`` as ints (MT: (src_ids, dst_ids,
    src_lang, dst_lang)), the others as int32 arrays."""

    def __init__(self, reader: PackedReader, scalar_fields: Sequence[int] = ()):
        self.reader = reader
        self.scalar_fields = frozenset(scalar_fields)

    def __len__(self):
        return len(self.reader)

    def __getitem__(self, i: int):
        r = self.reader
        return tuple(int(r.field(i, f)[0]) if f in self.scalar_fields
                     else r.field(i, f) for f in range(r.n_fields))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
