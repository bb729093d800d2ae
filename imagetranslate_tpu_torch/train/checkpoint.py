"""Checkpoints in the JAX package's directory layout (port of
imagetranslate_tpu/train/checkpoint.py), so a checkpoint written by either
package loads and decodes in the other:

    config.json        — Seq2SeqConfig (JSON)
    params.msgpack     — the flax parameter tree, as flax's msgpack_serialize
                         writes it (fp32 masters from a trainer; a captioning
                         checkpoint holds {"params", "batch_stats"})
    opt_state.msgpack  — the optax optimizer state tree (optional)
    meta.json          — {"step": int, "best_metric": float}

Neither flax nor the msgpack package is needed: this module reads and writes
the subset of msgpack that flax emits for a parameter tree — nested maps with
str keys, ints, floats, and arrays as ext type 1 whose payload is the msgpack
triple [shape, dtype name, raw C-order bytes]. An array above 1 GiB (an
NLLB-MoE bank's stacked experts, 4.3 GB in bf16) travels as flax chunks it:
a map ``{"__msgpack_chunked_array__": true, "shape": {"0": d0, ...},
"chunks": {"0": a0, ...}}`` of the flattened array cut every 1 GiB.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from imagetranslate_tpu_torch.models.config import Seq2SeqConfig

_EXT_NDARRAY = 1   # flax _MsgpackExtType.ndarray
_EXT_NPSCALAR = 3  # flax _MsgpackExtType.npscalar
_CHUNK_LIMIT = 2 ** 30  # flax MAX_CHUNK_SIZE

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn, "int8": torch.int8,
    "uint8": torch.uint8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


# ---------------- msgpack subset ----------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.obj() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        sized = {0xcc: "B", 0xcd: "H", 0xce: "I", 0xcf: "Q", 0xd0: "b",
                 0xd1: "h", 0xd2: "i", 0xd3: "q", 0xca: "f", 0xcb: "d"}
        if b in sized:
            return self.unpack(sized[b])
        lengths = {0xd9: "B", 0xda: "H", 0xdb: "I"}
        if b in lengths:
            return str(self.take(self.unpack(lengths[b])), "utf-8")
        lengths = {0xc4: "B", 0xc5: "H", 0xc6: "I"}
        if b in lengths:
            return bytes(self.take(self.unpack(lengths[b])))
        if b in (0xdc, 0xdd):
            n = self.unpack("H" if b == 0xdc else "I")
            return [self.obj() for _ in range(n)]
        if b in (0xde, 0xdf):
            return self.map(self.unpack("H" if b == 0xde else "I"))
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            code = self.unpack("b")
            return self.ext(code, self.take(fixext[b]))
        lengths = {0xc7: "B", 0xc8: "H", 0xc9: "I"}
        if b in lengths:
            n = self.unpack(lengths[b])
            code = self.unpack("b")
            return self.ext(code, self.take(n))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        if "__msgpack_chunked_array__" in out:
            shape = tuple(out["shape"][str(i)]
                          for i in range(len(out["shape"])))
            chunks = [out["chunks"][str(i)].reshape(-1)
                      for i in range(len(out["chunks"]))]
            return torch.cat(chunks).reshape(shape)
        return out

    @staticmethod
    def ext(code: int, payload: memoryview) -> torch.Tensor:
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, name, raw = _Reader(payload).obj()
        name = name.decode() if isinstance(name, bytes) else name
        if name not in _TORCH_DTYPES:
            raise ValueError(f"unsupported array dtype {name!r}")
        dtype = _TORCH_DTYPES[name]
        if not raw:
            return torch.empty(tuple(shape), dtype=dtype)
        return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(
            tuple(shape))


def _pack_len(out: bytearray, n: int, fix: Optional[int], fix_max: int,
              codes):
    """A length header: the fix form (``fix | n``) up to ``fix_max``, else
    the 8-, 16- or 32-bit form (``codes``; None where msgpack has none)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif n < 2 ** 8 and codes[0] is not None:
        out += struct.pack(">BB", codes[0], n)
    elif n < 2 ** 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack(out: bytearray, obj: Any):
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        t = torch.as_tensor(obj).detach().cpu().contiguous()
        if t.dtype not in _DTYPE_NAMES:
            raise ValueError(f"unsupported array dtype {t.dtype}")
        nbytes = t.numel() * t.element_size()
        if nbytes > _CHUNK_LIMIT:
            per = max(1, _CHUNK_LIMIT // t.element_size())
            flat = t.reshape(-1)
            _pack(out, {
                "__msgpack_chunked_array__": True,
                "shape": {str(i): int(d) for i, d in enumerate(t.shape)},
                "chunks": {str(i): flat[lo:lo + per] for i, lo in
                           enumerate(range(0, flat.numel(), per))}})
            return
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        payload = bytearray()
        _pack(payload, [list(t.shape), _DTYPE_NAMES[t.dtype], raw])
        n = len(payload)
        fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _pack_len(out, n, None, 0, (0xc7, 0xc8, 0xc9))
        out += struct.pack(">b", _EXT_NDARRAY) + payload
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xde, 0xdf))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise ValueError(f"map keys must be str, got {type(k)}")
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xdc, 0xdd))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), 0xa0, 31, (0xd9, 0xda, 0xdb))
        out += b
    elif isinstance(obj, bytes):
        _pack_len(out, len(obj), None, 0, (0xc4, 0xc5, 0xc6))
        out += obj
    elif isinstance(obj, bool):
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7f or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        else:
            out += struct.pack(">Bq", 0xd3, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xcb, obj)
    else:
        raise ValueError(f"cannot serialize {type(obj)}")


def msgpack_dumps(tree: Any) -> bytes:
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def msgpack_loads(data: bytes) -> Any:
    reader = _Reader(data)
    obj = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


# ---------------- checkpoint directory ----------------

def _atomic_write(path: str, data, mode: str = "wb"):
    """Write a sibling temp file and rename it into place, so a killed save
    never leaves a truncated file."""
    tmp = path + ".tmp"
    with open(tmp, mode) as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_checkpoint(out_dir: str, cfg: Seq2SeqConfig, params: Mapping,
                    opt_state: Optional[Mapping] = None, step: int = 0,
                    best_metric: Optional[float] = None):
    """Write a checkpoint directory. ``params`` is the flax-layout tree
    (``{"params": {...}}``) of tensors or numpy arrays
    (``train/weights.flax_from_state_dict`` makes it from a port
    ``state_dict``); ``opt_state`` the optax-layout tree
    (``train/weights.flax_from_opt_state``), written when given."""
    os.makedirs(out_dir, exist_ok=True)
    _atomic_write(os.path.join(out_dir, "config.json"), cfg.to_json(), "w")
    _atomic_write(os.path.join(out_dir, "params.msgpack"),
                  msgpack_dumps(params))
    if opt_state is not None:
        _atomic_write(os.path.join(out_dir, "opt_state.msgpack"),
                      msgpack_dumps(opt_state))
    meta = {"step": int(step)}
    if best_metric is not None:
        meta["best_metric"] = float(best_metric)
    _atomic_write(os.path.join(out_dir, "meta.json"), json.dumps(meta), "w")


def save_params(out_dir: str, cfg: Seq2SeqConfig, params: Mapping,
                step: int = 0):
    """A weights-only checkpoint: ``config.json``, ``params.msgpack`` and
    ``meta.json``."""
    save_checkpoint(out_dir, cfg, params, step=step)


def load_config(out_dir: str) -> Seq2SeqConfig:
    with open(os.path.join(out_dir, "config.json")) as f:
        return Seq2SeqConfig.from_json(f.read())


def load_variables(out_dir: str) -> dict:
    """The whole tree of ``params.msgpack``, leaves as CPU tensors: for a
    captioning checkpoint ``{"params": {...}, "batch_stats": {...}}``
    (``train/weights.CAPTION`` maps it onto ``ImageSeq2Seq.state_dict()``)."""
    with open(os.path.join(out_dir, "params.msgpack"), "rb") as f:
        return msgpack_loads(f.read())


def load_params(out_dir: str) -> dict:
    """The flax-layout parameter tree of ``params.msgpack``, leaves as CPU
    tensors. A text ``Seq2Seq`` also loads from a multimodal checkpoint: its
    weights are that tree's ``core`` subtree."""
    tree = load_variables(out_dir)
    p = tree.get("params", tree)
    if "core" in p and "embeddings" not in p:
        return {"params": p["core"]}
    return tree


def load_checkpoint(out_dir: str,
                    with_opt_state: bool = False) -> Tuple[dict,
                                                           Optional[dict],
                                                           dict]:
    """(params tree, optax-layout optimizer state tree or None, meta). The
    optimizer state is read when asked for and present."""
    params = load_params(out_dir)
    opt_state = None
    opt_path = os.path.join(out_dir, "opt_state.msgpack")
    if with_opt_state and os.path.exists(opt_path):
        with open(opt_path, "rb") as f:
            opt_state = msgpack_loads(f.read())
    meta = {"step": 0}
    meta_path = os.path.join(out_dir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return params, opt_state, meta
