"""The captioner's image encoder in plain PyTorch, fp32: a ResNet
(torchvision's BasicBlock layout, BatchNorm in inference with its running
statistics, eps 1e-5) over ImageNet-normalised pixels, its last feature map
read as a grid of (S/32)^2 slots in row-major order, a bias-free Linear to
the model width and a learned location embedding added (the reference
repository's ``image_model.py`` grid encoder). Weights are the state_dict
entries under ``image_model.``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.precision import FP32

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5


def _bn(x, W, name):
    scale = W[name + ".weight"] * torch.rsqrt(W[name + ".running_var"]
                                              + BN_EPS)
    return ((x - W[name + ".running_mean"][None, :, None, None])
            * scale[None, :, None, None] + W[name + ".bias"][None, :, None,
                                                             None])


def resnet_grid(W, images: torch.Tensor, blocks=(2, 2, 2, 2),
                prec=FP32) -> torch.Tensor:
    """images [B, S, S, 3] uint8 -> grid [B, (S/32)^2, E] fp32."""
    p = "image_model."
    mean = torch.tensor(MEAN, device=images.device)
    std = torch.tensor(STD, device=images.device)
    x = ((images.to(torch.float32) / 255.0 - mean) / std).permute(0, 3, 1, 2)
    x = F.relu(_bn(prec.conv2d(x, W[p + "conv1.weight"], 2, 3), W,
                   p + "bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, n in enumerate(blocks):
        for j in range(n):
            b = f"{p}layer{stage + 1}.{j}."
            stride = 2 if stage > 0 and j == 0 else 1
            y = F.relu(_bn(prec.conv2d(x, W[b + "conv1.weight"], stride, 1),
                           W, b + "bn1"))
            y = _bn(prec.conv2d(y, W[b + "conv2.weight"], 1, 1), W,
                    b + "bn2")
            if b + "downsample.0.weight" in W:
                x = _bn(prec.conv2d(x, W[b + "downsample.0.weight"], stride,
                                    0), W, b + "downsample.1")
            x = F.relu(y + x)
    B, C = x.shape[:2]
    grid = x.permute(0, 2, 3, 1).reshape(B, -1, C)
    return (prec.linear(grid, W[p + "fc.weight"])
            + W[p + "location_embedding"][None])
