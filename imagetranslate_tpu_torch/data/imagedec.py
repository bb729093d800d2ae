"""The native JPEG decode + resize (port of imagetranslate_tpu/data/imagedec.py):
a ctypes binding of ``data/_native/imagedec.cpp``, built by ``g++`` against
libjpeg at first use (``utils/native.py``).

``decode_resize(path, size, resize_min)`` gives the reference transform
(resize the short side to ``resize_min``, centre crop to ``size``, the crop
fused into the bilinear resize, as ``data/images.py::load_image`` does it) as
uint8 [size, size, 3], or None where the native path does not take the input
(not a JPEG, CMYK, a decode error, ``size > resize_min``, or a host without
``g++`` or ``jpeglib.h``): the caller then decodes with Pillow.

``FAST_DCT_SCALE`` (on unless the environment sets ``ITR_FAST_DCT_SCALE=0``)
lets libjpeg prescale a large JPEG by 1/2, 1/4 or 1/8 in the DCT domain
while the scaled short side still covers ``resize_min``. The pixels then
differ from a full-resolution decode. It is the JAX package's default, and
``load_image`` takes this path first in both packages, so both feed the
same pixels to the image tower.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from imagetranslate_tpu_torch.utils import native

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native",
                   "imagedec.cpp")

FAST_DCT_SCALE = os.environ.get("ITR_FAST_DCT_SCALE", "1") != "0"


def _declare(lib):
    lib.itdec_decode_resize.restype = ctypes.c_int
    lib.itdec_decode_resize.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int)]


def get_lib():
    """The decoder library, or None where it cannot be built."""
    return native.load("imagedec", SRC, libs=("-ljpeg",), declare=_declare)


def _looks_jpeg(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(2) == b"\xff\xd8"
    except OSError:
        return False


def decode_resize_info(path: str, size: int = 224, resize_min: int = 256,
                       fast_scale: Optional[bool] = None):
    """(uint8 [size, size, 3], the DCT prescale's denominator: 1 for a
    full-resolution decode), or (None, 0) where the caller takes Pillow."""
    lib = get_lib()
    if lib is None or not _looks_jpeg(path):
        return None, 0
    if fast_scale is None:
        fast_scale = FAST_DCT_SCALE
    out = np.empty((size, size, 3), np.uint8)
    denom = ctypes.c_int(0)
    rc = lib.itdec_decode_resize(
        os.fsencode(path), size, resize_min, 1 if fast_scale else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.byref(denom))
    if rc != 0:
        return None, 0
    return out, denom.value


def decode_resize(path: str, size: int = 224, resize_min: int = 256,
                  fast_scale: Optional[bool] = None) -> Optional[np.ndarray]:
    """uint8 [size, size, 3] through the native path, or None."""
    return decode_resize_info(path, size, resize_min, fast_scale)[0]
