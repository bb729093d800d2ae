"""Build the port's CUDA kernels and load them with ctypes.

``nvcc`` compiles every ``imagetranslate_tpu_torch/csrc/*.cu`` (one process
per source, all started together; they include the headers ``csrc/*.cuh``)
and links the objects into one shared library with a plain C interface, for
``sm_90a`` (Hopper), at first use. The library lands in
``imagetranslate_tpu_torch/_build/<hash>/``, keyed on a hash of the sources,
the headers and the flags, so a changed source or header rebuilds and an
unchanged one loads at once. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_capability = {}   # device -> its compute capability, asked once


def require_hopper(device, what: str):
    """Raise unless ``device`` is a Hopper card: ``what`` (the kernels' name
    in the message) is built for sm_90a only."""
    import torch

    if device not in _capability:
        _capability[device] = torch.cuda.get_device_capability(device)
    if _capability[device][0] < 9:
        raise RuntimeError(f"{what} built for sm_90a (Hopper); device "
                           f"{device} has capability {_capability[device]}")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> str:
    """Where the library for the current sources and headers lives (built or
    not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, digest.hexdigest()[:16],
                        "libitt_kernels.so")


def _run(cmds):
    """Start every command at once, wait for all, raise on the first that
    failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, output in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                               + output)


def build() -> str:
    """Compile the sources if their library is missing; return its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
        objects = [os.path.join(tmp, os.path.basename(src) + ".o")
                   for src in _sources()]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
              for src, obj in zip(_sources(), objects)])
        lib = os.path.join(tmp, "lib.so")
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objects]])
        os.replace(lib, out)  # atomic: a concurrent build sees all or nothing
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, declaring every entry
    point's argument types: pointers and the stream as c_void_p."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        f, u = ctypes.c_float, ctypes.c_uint
        # h w bias part_val part_idx part_ms val idx lse | M E V k | cols per
        # ranges | stream
        lib.itt_project_topk_bf16.argtypes = [p] * 9 + [i] * 7 + [p]
        lib.itt_project_topk_bf16.restype = ctypes.c_int
        # val idx lse out_val out_idx out_lse | M n k | stream
        lib.itt_topk_merge.argtypes = [p] * 6 + [i] * 3 + [p]
        lib.itt_topk_merge.restype = ctypes.c_int
        # q k v bias out stats | B T S H D bias_rows | scale keep_prob |
        # threshold seed_lo seed_hi | stream
        lib.itt_fused_attn_fwd_bf16.argtypes = (
            [p] * 6 + [i] * 6 + [f] * 2 + [u] * 3 + [p])
        lib.itt_fused_attn_fwd_bf16.restype = ctypes.c_int
        # q k v bias g stats delta dq dk dv db_part dbias | then as the
        # forward
        lib.itt_fused_attn_bwd_bf16.argtypes = (
            [p] * 12 + [i] * 6 + [f] * 2 + [u] * 3 + [p])
        lib.itt_fused_attn_bwd_bf16.restype = ctypes.c_int
        # B T S H D
        lib.itt_fused_attn_supported.argtypes = [i] * 5
        lib.itt_fused_attn_supported.restype = ctypes.c_int
        # x targets loss logz | N V is_bf16 | 1-eps eps/V | stream
        lib.itt_xent_fwd.argtypes = (
            [p] * 4 + [ctypes.c_longlong, i, i] + [f] * 2 + [p])
        lib.itt_xent_fwd.restype = ctypes.c_int
        # x targets logz g dx | then as the forward
        lib.itt_xent_bwd.argtypes = (
            [p] * 5 + [ctypes.c_longlong, i, i] + [f] * 2 + [p])
        lib.itt_xent_bwd.restype = ctypes.c_int
        # q k v bias out | B T S H D | bias batch stride | scale | stream
        lib.itt_flash_attn_fwd_bf16.argtypes = (
            [p] * 5 + [i] * 5 + [ctypes.c_longlong, f, p])
        lib.itt_flash_attn_fwd_bf16.restype = ctypes.c_int
        # q main_k main_v win_k win_v rowsel wanc out scratch | R K H D t0
        # wlive W | main row stride, window row stride | scale | clusters
        # groups wph per spos depth scratch | stream
        lib.itt_decode_attn_bf16.argtypes = (
            [p] * 9 + [i] * 7 + [ctypes.c_longlong] * 2 + [f] + [i] * 7
            + [p])
        lib.itt_decode_attn_bf16.restype = ctypes.c_int
        lib.itt_error_string.argtypes = [i]
        lib.itt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
