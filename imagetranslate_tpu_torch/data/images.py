"""Host-side image pipeline and caption batching (port of
imagetranslate_tpu/data/images.py: IMAGENET_MEAN/STD, normalize_uint8,
load_image's PIL path, CaptionBatch, load_caption_bin, ObjectStore,
CaptionBatcher, CaptionEvalGroup, CaptionEvalSet and ImageFolderBatcher).

The transform is the JAX package's: resize so that the short side is
``resize_min`` (256 unless the crop is larger), centre crop to ``size``, with
the crop fused into the bilinear resize; a file that cannot be read becomes a
black image; ``.png`` entries are skipped. Output is channels last, uint8
(``raw=True``) or ImageNet-normalised float32. (The JAX package first tries
its C++ JPEG decoder and falls back to this path; that decoder is not ported,
so Pillow decodes every file here.)

Caption batches keep the reference's budgets (``max_img_per_batch`` images,
a cubic capacity ``2 * t^3 * n`` bytes) over length buckets, and pad their
rows to a multiple of 8 with copies of row 0 under ``row_mask``; images
decode lazily, a batch at a time. A caption binary is the marshal tuple
(unique_images {id: path}, [(image_id, caption_ids), ...]) that
``data.binarize_captions`` writes; the packed record format is not ported
(ROADMAP module 15).
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from imagetranslate_tpu_torch.data.binarize import _load_marshal
from imagetranslate_tpu_torch.data.loader import bucket_len

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


def _round_up_rows(n: int) -> int:
    return -(-n // ROW_QUANTUM) * ROW_QUANTUM


@dataclasses.dataclass
class CaptionBatch:
    image_paths: List[str]       # one a row, padding rows included
    captions: np.ndarray         # [N, T] int32
    caption_mask: np.ndarray     # [N, T]
    langs: np.ndarray            # [N] language type id
    lengths: np.ndarray          # [N] first-pad index
    row_mask: np.ndarray         # [N]

    def images(self, root_dir: str = "", size: int = 224,
               raw: bool = False) -> np.ndarray:
        """The batch's images, decoded on the shared thread pool."""
        from imagetranslate_tpu_torch.data.prefetch import default_image_pool

        paths = list(self.image_paths)
        while len(paths) < self.captions.shape[0]:
            paths.append(paths[0])        # padding rows: zero loss weight
        return default_image_pool().decode(paths, root=root_dir, size=size,
                                           raw=raw)


def load_caption_bin(data_bin_file: str):
    """(unique_images {id: path}, [(image_id, caption_ids), ...]) from a
    marshal caption binary; a packed record file raises."""
    return _load_marshal(data_bin_file)


class ObjectStore:
    """Precomputed detections: an .npz with "<path>||feat" [O, F] float32
    and "<path>||lab" [O] int32 per image. An image without an entry gets
    all-zero (masked-out) object slots."""

    def __init__(self, npz_path: str):
        self._z = np.load(npz_path)
        feat_keys = [k for k in self._z.files if k.endswith("||feat")]
        if not feat_keys:
            raise ValueError(f"no detections in {npz_path}")
        first = self._z[feat_keys[0]]
        self.n_obj, self.feat_dim = first.shape

    def lookup(self, paths: Sequence[str], n_rows: int):
        feats = np.zeros((n_rows, self.n_obj, self.feat_dim), np.float32)
        labels = np.zeros((n_rows, self.n_obj), np.int32)
        for i, p in enumerate(paths[:n_rows]):
            if f"{p}||feat" in self._z.files:
                feats[i] = self._z[f"{p}||feat"]
                labels[i] = self._z[f"{p}||lab"]
        return feats, labels


class CaptionBatcher:
    """Bucketed fixed-shape batches of a caption binary, in its (length)
    order; ``.png`` images are skipped. A batch closes when the next
    caption's bucket differs, or when one more row would pass
    ``max_img_per_batch`` or the capacity ``2 * t^3 * rows`` bytes."""

    def __init__(self, data_bin_file: str, tp, max_capacity_mb: int = 50,
                 max_img_per_batch: int = 32, bucket_step: int = 16):
        self.pad_id = tp.pad_token_id()
        self.unique_images, captions = load_caption_bin(data_bin_file)
        lang_token = tp.id2token(captions[0][1][0])
        self.lang = tp.languages.get(lang_token, 0)
        self.all_captions = []
        self.batches: List[CaptionBatch] = []

        cur: List[Tuple[int, list]] = []
        cur_t = 0
        cap = max_capacity_mb * 1_000_000
        for image_id, caption in captions:
            if self.unique_images[image_id].lower().endswith(".png"):
                continue
            self.all_captions.append(list(caption))
            t = bucket_len(len(caption), bucket_step)
            nt = max(cur_t, t)
            too_big = (len(cur) + 1 > max_img_per_batch
                       or 2 * (nt ** 3) * (len(cur) + 1) > cap)
            if cur and (nt != cur_t or too_big):
                self.batches.append(self._pack(cur, cur_t))
                cur, nt = [], t
            cur.append((image_id, list(caption)))
            cur_t = nt
        if cur:
            self.batches.append(self._pack(cur, cur_t))

    def _pack(self, rows, t) -> CaptionBatch:
        n = len(rows)
        rows_padded = _round_up_rows(n)
        caps = np.full((rows_padded, t), self.pad_id, np.int32)
        lengths = np.ones((rows_padded,), np.int32)
        row_mask = np.zeros((rows_padded,), bool)
        paths = []
        for i, (img_id, ids) in enumerate(rows):
            ids = ids[:t]
            caps[i, :len(ids)] = ids
            lengths[i] = len(ids)
            row_mask[i] = True
            paths.append(self.unique_images[img_id])
        if n < rows_padded:
            caps[n:] = caps[0]
            lengths[n:] = lengths[0]
            paths.extend([paths[0]] * (rows_padded - n))
        return CaptionBatch(paths, caps, caps != self.pad_id,
                            np.full((rows_padded,), self.lang, np.int32),
                            lengths, row_mask)

    def __len__(self):
        return len(self.batches)

    def __iter__(self) -> Iterator[CaptionBatch]:
        return iter(self.batches)

    def shuffled(self, seed: int) -> Iterator[CaptionBatch]:
        order = list(range(len(self.batches)))
        random.Random(seed).shuffle(order)
        for i in order:
            yield self.batches[i]

    def sample_negatives(self, batch_size: int, seed: int) -> np.ndarray:
        """At least 30 random other captions, padded to a bucket."""
        k = min(len(self.all_captions), max(30, batch_size))
        samples = random.Random(seed).sample(self.all_captions, k)
        t = bucket_len(max(len(s) for s in samples))
        out = np.full((k, t), self.pad_id, np.int32)
        for i, s in enumerate(samples):
            out[i, :min(len(s), t)] = s[:t]
        return out


@dataclasses.dataclass
class CaptionEvalGroup:
    image_path: str
    image_id: int
    first_token: int
    references: List[List[int]]   # tokenized, language token and eos kept


class CaptionEvalSet:
    """A caption binary as evaluation groups: one per image (deduplicated
    over the whole file), with every reference caption of that image;
    ``max_len`` is the longest reference + 10."""

    def __init__(self, data_bin_file: str, tp):
        unique_images, captions = load_caption_bin(data_bin_file)
        lang_token = tp.id2token(captions[0][1][0])
        self.lang = tp.languages.get(lang_token, 0)
        groups: Dict[int, CaptionEvalGroup] = {}
        self.max_len = 0
        for image_id, caption in captions:
            if unique_images[image_id].lower().endswith(".png"):
                continue
            if image_id not in groups:
                groups[image_id] = CaptionEvalGroup(
                    unique_images[image_id], image_id, int(caption[0]), [])
            groups[image_id].references.append(list(caption))
            self.max_len = max(self.max_len, len(caption))
        self.max_len += 10
        self.groups = list(groups.values())

    def batches(self, max_img_per_batch: int = 16):
        for i in range(0, len(self.groups), max_img_per_batch):
            yield self.groups[i:i + max_img_per_batch]


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
            rows = _round_up_rows(len(paths))
            if rows > len(paths):
                pad = np.repeat(images[:1], rows - len(paths), axis=0)
                images = np.concatenate([images, pad])
            yield {
                "paths": paths,
                "images": images,
                "first_tokens": np.full((rows,), self.first_token, np.int32),
                "tgt_langs": np.full((rows,), self.target_lang, np.int32),
            }
