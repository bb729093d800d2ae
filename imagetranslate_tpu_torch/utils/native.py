"""Build the port's C++ host libraries with ``g++`` and load them with ctypes.

Three sources live beside the modules that bind them: the ITR1 record reader
and writer (``data/_native/recordio.cpp``), the BPE encoder and trainer
(``text/_native/bpe.cpp``) and the JPEG decode + resize
(``data/_native/imagedec.cpp``, linked with ``-ljpeg``). Each is compiled at
first use into ``imagetranslate_tpu_torch/_build/<hash>/lib<name>.so``, keyed
on a hash of the source and the command, as ``ops/_build.py`` keys the CUDA
kernels: a changed source rebuilds, an unchanged one loads at once, and
nothing is written beside the sources. A host without ``g++`` (or without
``jpeglib.h``, for the decoder) gets None, and the caller takes its plain
Python path, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Dict, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

# name -> the path of the library this process loaded, and whether this
# process compiled it (False: an earlier build of the same source).
LOADED: Dict[str, str] = {}
COMPILED: Dict[str, bool] = {}
_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}


def library_path(name: str, src: str, libs: Sequence[str] = ()) -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + list(libs)).encode())
    with open(src, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, digest.hexdigest()[:16], f"lib{name}.so")


def build(name: str, src: str, libs: Sequence[str] = ()) -> Optional[str]:
    """Compile ``src`` unless its library exists; its path, or None when the
    compiler is missing or refuses the source."""
    out = library_path(name, src, libs)
    if os.path.exists(out):
        COMPILED.setdefault(name, False)
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
        lib = os.path.join(tmp, os.path.basename(out))
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", lib, src, *libs],
                           check=True, capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(lib, out)   # atomic: a concurrent build sees all or none
    COMPILED[name] = True
    return out


def load(name: str, src: str, libs: Sequence[str] = (),
         declare=None) -> Optional[ctypes.CDLL]:
    """The loaded library ``name`` (built first if needed), its entry points
    declared by ``declare(lib)``; None where it cannot be built. Asked once
    a process: a failed build is not retried."""
    if name in _libs:
        return _libs[name]
    with _lock:
        if name not in _libs:
            path = build(name, src, libs)
            lib = None
            if path is not None:
                try:
                    lib = ctypes.CDLL(path)
                except OSError:     # built, but a library it needs is gone
                    lib = None
            if lib is not None:
                if declare is not None:
                    declare(lib)
                LOADED[name] = path
            _libs[name] = lib
    return _libs[name]


def has_header(header: str) -> bool:
    """Does ``g++`` find ``#include <header>`` on this host?"""
    try:
        subprocess.run(["g++", "-x", "c++", "-E", "-o", os.devnull, "-"],
                       input=f"#include <{header}>\n".encode(), check=True,
                       capture_output=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return False
    return True
