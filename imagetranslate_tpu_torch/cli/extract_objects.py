"""Offline object-feature extraction (port of
imagetranslate_tpu/cli/extract_objects.py): the Faster R-CNN over a folder
or a list of images, the per-detection pooled features and labels stored for
the object-stream captioner (``CaptionTrainer --obj-feats``, ``caption_batches``).
The same flags and the same file, plus ``--device``.

    python -m imagetranslate_tpu_torch.cli.extract_objects \
        --input IMAGEDIR_OR_LIST --fcnn fasterrcnn.pth --output dets.npz \
        [--batch 8] [--device cuda]

Output: an .npz with "<path>||feat" [O, 1031] float32 (1024 pooled + 7
geometry) and "<path>||lab" [O] int32 per image, which
``data.images.ObjectStore`` reads.
"""

from __future__ import annotations

import argparse
import os
import sys


def iter_paths(input_path: str):
    """The ``.jpg`` / ``.jpeg`` files of a folder, sorted, or the first
    column of a TSV / list file."""
    if os.path.isdir(input_path):
        for name in sorted(os.listdir(input_path)):
            if name.lower().endswith((".jpg", ".jpeg")):
                yield os.path.join(input_path, name)
    else:
        with open(input_path) as r:
            for line in r:
                p = line.strip().split("\t")[0]
                if p:
                    yield p


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("extract_objects")
    p.add_argument("--input", dest="input_path", required=True,
                   help="image folder or TSV/list file of image paths")
    p.add_argument("--fcnn", dest="detector_path", required=True,
                   help="torchvision fasterrcnn_resnet50_fpn state_dict .pth")
    p.add_argument("--output", dest="output_path", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device to detect on (cuda, cuda:N or cpu)")
    return p


def main(argv=None):
    options = get_parser().parse_args(argv)

    import numpy as np

    from imagetranslate_tpu_torch.cli.caption import (
        DET_SIZE,
        build_object_extractor,
    )
    from imagetranslate_tpu_torch.data.prefetch import default_image_pool

    extract = build_object_extractor(options.detector_path, options.device)

    out = {}
    paths = list(iter_paths(options.input_path))
    for i in range(0, len(paths), options.batch):
        chunk = paths[i:i + options.batch]
        # uint8 off the decode pool; the detector normalises on the device.
        imgs = default_image_pool().decode(chunk, size=DET_SIZE,
                                           resize_min=DET_SIZE, raw=True)
        feats, labels = extract(imgs)
        feats, labels = feats.cpu().numpy(), labels.cpu().numpy()
        for j, p_ in enumerate(chunk):
            out[f"{p_}||feat"] = feats[j]
            out[f"{p_}||lab"] = labels[j]
        print(f"{min(i + options.batch, len(paths))}/{len(paths)}",
              end="\r", file=sys.stderr)

    np.savez_compressed(options.output_path, **out)
    print(f"\nWrote detections for {len(paths)} images "
          f"to {options.output_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
