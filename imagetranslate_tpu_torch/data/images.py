"""Host-side image pipeline of the caption CLI (port of
imagetranslate_tpu/data/images.py: IMAGENET_MEAN/STD, normalize_uint8,
load_image's PIL path and ImageFolderBatcher).

The transform is the JAX package's: resize so that the short side is
``resize_min`` (256 unless the crop is larger), centre crop to ``size``, with
the crop fused into the bilinear resize; a file that cannot be read becomes a
black image; ``.png`` entries are skipped. Output is channels last, uint8
(``raw=True``) or ImageNet-normalised float32. (The JAX package first tries
its C++ JPEG decoder and falls back to this path; that decoder is not ported,
so Pillow decodes every file here.)
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
ROW_QUANTUM = 8   # a tail batch's rows pad up to a multiple of this


def normalize_uint8(images: torch.Tensor) -> torch.Tensor:
    """Device-side ImageNet normalisation of raw uint8 images [..., 3]:
    ``(x / 255 - mean) / std`` in fp32, the arithmetic and the order of
    ``load_image``'s float path."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, device=images.device)
    return (images.to(torch.float32) / 255.0 - mean) / std


def load_image(path: str, size: int = 224, resize_min: Optional[int] = None,
               raw: bool = False) -> np.ndarray:
    """Decode, resize and crop one image to [size, size, 3]: normalised
    float32, or with ``raw=True`` uint8 without normalisation (the models
    normalise uint8 input on the device with the same arithmetic)."""
    if resize_min is None:
        resize_min = max(256, size)
    try:
        from PIL import Image

        with Image.open(path) as im:
            im.draft("RGB", im.size)
            img = im if im.mode == "RGB" else im.convert("RGB")
            w, h = img.size
            scale = resize_min / min(w, h)
            rw = max(1, round(w * scale))
            rh = max(1, round(h * scale))
            left, top = (rw - size) // 2, (rh - size) // 2
            if left >= 0 and top >= 0:
                # The crop fused into the resize: sample only the source
                # region that the crop keeps.
                img = img.resize(
                    (size, size), Image.BILINEAR,
                    box=(left * w / rw, top * h / rh,
                         (left + size) * w / rw, (top + size) * h / rh))
            else:
                # size > resize_min: resize, then crop (Pillow pads what
                # lies outside with black).
                img = img.resize((rw, rh), Image.BILINEAR)
                img = img.crop((left, top, left + size, top + size))
            u8 = np.asarray(img, np.uint8)
    except Exception:
        print(f"Corrupted image {path}")
        u8 = np.zeros((size, size, 3), np.uint8)
    if raw:
        return u8
    return (u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


class ImageFolderBatcher:
    """Folder of jpgs -> fixed-size uint8 image batches for the caption CLI
    (``.png`` entries are skipped). Each batch is a dict of ``paths`` (the
    real files), ``images`` [rows, S, S, 3] uint8, ``first_tokens`` and
    ``tgt_langs`` [rows]; a tail batch's rows pad up to a multiple of 8 with
    copies of its first image, and the caller drops the captions past
    ``len(paths)``."""

    def __init__(self, root_img_dir: str, max_img_per_batch: int,
                 target_lang: int, first_token: int, img_size: int = 224):
        self.target_lang = target_lang
        self.first_token = first_token
        # The checkpoint's training resolution: the grid has (img_size/32)^2
        # slots, and the location table has as many rows.
        self.img_size = img_size
        paths = [os.path.join(root_img_dir, p)
                 for p in sorted(os.listdir(root_img_dir))
                 if not p.lower().endswith(".png")]
        self.batches = [paths[i:i + max_img_per_batch]
                        for i in range(0, len(paths), max_img_per_batch)]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        from imagetranslate_tpu_torch.data.prefetch import default_image_pool

        for paths in self.batches:
            images = default_image_pool().decode(paths, size=self.img_size,
                                                 raw=True)
            rows = -(-len(paths) // ROW_QUANTUM) * ROW_QUANTUM
            if rows > len(paths):
                pad = np.repeat(images[:1], rows - len(paths), axis=0)
                images = np.concatenate([images, pad])
            yield {
                "paths": paths,
                "images": images,
                "first_tokens": np.full((rows,), self.first_token, np.int32),
                "tgt_langs": np.full((rows,), self.target_lang, np.int32),
            }
