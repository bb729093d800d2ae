"""Image-set similarity between foreign and English MMID word folders (port
of imagetranslate_tpu/mmid/mmid_sim.py): each image embeds through a
``ResNetGrid`` (the grid's mean, L2-normalised), and a pair of folders
scores the average over the foreign images of their best cosine against
the English images.

    python -m imagetranslate_tpu_torch.mmid.mmid_sim --foreign FDIR \
        --en ENDIR --output sims.tsv [--max-img 10] [--depth 1] \
        [--device cuda]

``--foreign`` holds one folder of images a word; ``--en`` one folder a
letter, each holding word folders (or images). The output has lines
"foreign_dir\\ten_dir\\tavg_max_cos". The network's weights are drawn from
seed 0 (``weights.random_resnet_state_dict``), not trained: the JAX CLI
draws its own through flax's initializer, so the two CLIs' scores differ.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


@torch.no_grad()
def embed(resnet, images: torch.Tensor) -> torch.Tensor:
    """images [B, S, S, 3] normalised -> [B, E]: the mean of the grid over
    its slots, divided by its L2 norm + 1e-4."""
    vec = torch.mean(resnet(images), dim=1)
    return vec / (torch.linalg.vector_norm(vec, dim=-1, keepdim=True) + 1e-4)


def avg_max_cosine(fv: np.ndarray, ev: np.ndarray) -> float:
    """The mean over the rows of ``fv`` of their best cosine against the
    rows of ``ev`` (both L2-normalised)."""
    return float((fv @ ev.T).max(axis=1).mean())


def main(argv=None):
    p = argparse.ArgumentParser("mmid_sim")
    p.add_argument("--foreign", dest="foreign_folder", required=True)
    p.add_argument("--en", dest="en_folder", required=True)
    p.add_argument("--output", dest="output_file", required=True)
    p.add_argument("--max-img", dest="max_img", type=int, default=10)
    p.add_argument("--depth", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device to embed on (cuda, cuda:N or cpu)")
    a = p.parse_args(argv)

    from imagetranslate_tpu_torch.data.images import load_image
    from imagetranslate_tpu_torch.models.resnet import ResNetGrid
    from imagetranslate_tpu_torch.train.weights import (
        random_resnet_state_dict,
    )

    device = torch.device(a.device)
    model = ResNetGrid(512, depth=a.depth, dropout=0.0, device=device)
    model.load_state_dict(random_resnet_state_dict(a.depth, 512))
    model.eval()

    def folder_vectors(folder):
        paths = [os.path.join(folder, f) for f in sorted(os.listdir(folder))
                 if f.lower().endswith((".jpg", ".jpeg"))][:a.max_img]
        if not paths:
            return None
        batch = np.stack([load_image(p) for p in paths])
        return embed(model, torch.as_tensor(batch).to(device)).cpu().numpy()

    foreign = []
    for name in sorted(os.listdir(a.foreign_folder)):
        d = os.path.join(a.foreign_folder, name)
        if not os.path.isdir(d):
            continue
        v = folder_vectors(d)
        if v is not None:
            foreign.append((d, v))
    print(f"{len(foreign)} foreign folders embedded")

    with open(a.output_file, "w") as w:
        for en_group in sorted(os.listdir(a.en_folder)):
            group_dir = os.path.join(a.en_folder, en_group)
            if not os.path.isdir(group_dir):
                continue
            subdirs = [os.path.join(group_dir, s)
                       for s in sorted(os.listdir(group_dir))]
            subdirs = [s for s in subdirs if os.path.isdir(s)] or [group_dir]
            for en_dir in subdirs:
                ev = folder_vectors(en_dir)
                if ev is None:
                    continue
                for f_dir, fv in foreign:
                    w.write(f_dir + "\t" + en_dir + "\t"
                            + str(avg_max_cosine(fv, ev)) + "\n")
    print("Finished")


if __name__ == "__main__":
    main()
