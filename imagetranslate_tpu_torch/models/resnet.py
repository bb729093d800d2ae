"""ResNet grid encoder for the image branch (port of
imagetranslate_tpu/models/resnet.py: DEPTHS, BasicBlock, Bottleneck,
ResNetGrid).

    images [B, S, S, 3] normalized, channels last -> grid [B, (S/32)^2, E]

The public layout is the JAX module's (channels last in, grid slots in row
major order out); inside, the convolutions run on the NCHW view of the same
memory (a permute, no copy), and the grid is flattened from the channels-last
view so that slot ``y * w + x`` is the JAX module's. ``state_dict`` keys are
torchvision's (``layer1.0.conv1.weight``, ``layer2.0.downsample.0.weight``,
``bn1.running_mean``), plus ``fc.weight`` and ``location_embedding``, as
imagetranslate_tpu/train/torch_import.py maps them.

Convolutions, pooling and batch normalisation are library calls here as they
are in the JAX module. Convolution and ``fc`` weights are stored in
``param_dtype`` and used in the input's dtype. BatchNorm (eps 1e-5) runs in
fp32 on fp32 parameters and statistics and casts back to the input's dtype
(the flax module's fp32 BatchNorm leaves fp32 behind it, so that under a bf16
config its later convolutions run in fp32; here they stay in the compute
dtype). ``train=True`` normalises with the batch's statistics and moves the
running ones with momentum 0.9, both with the biased variance, as flax does.
Under a data group (``BatchNorm2d.dp``, set by ``ImageSeq2Seq.shard_``) the
batch statistics are the global batch's, as XLA's cross-device reductions
give them in JAX: the mean from the group's sums, then the variance from the
group's sums of squared deviations from it (two passes, as the one-process
variance), each summed with its gradient (``all_reduce_autograd``); the
running statistics move alike on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from imagetranslate_tpu_torch.parallel.comm import all_reduce_autograd

DEPTHS = {
    1: ("basic", (2, 2, 2, 2), 1, 64),       # resnet18
    2: ("basic", (3, 4, 6, 3), 1, 64),       # resnet34
    3: ("bottleneck", (3, 4, 6, 3), 1, 64),  # resnet50
    4: ("bottleneck", (3, 4, 23, 3), 1, 64),  # resnet101
    5: ("bottleneck", (3, 8, 36, 3), 1, 64),  # resnet152
    6: ("bottleneck", (3, 4, 23, 3), 32, 8),  # resnext101_32x8d
}

BN_EPS = 1e-5
BN_MOMENTUM = 0.9   # flax's: running = 0.9 * running + 0.1 * batch


class Conv2d(nn.Conv2d):
    """Bias-free nn.Conv2d whose weight is cast to the input's dtype at each
    use, so it may be stored as an fp32 master."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, groups=1,
                 device=None, dtype=None):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         groups=groups, bias=False, device=device,
                         dtype=dtype)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                        self.padding, self.dilation, self.groups)


class BatchNorm2d(nn.Module):
    """Batch normalisation over [B, C, H, W] in fp32, cast back to the
    input's dtype; ``train`` is an argument, not the module's mode. ``dp``:
    the data group whose global batch the statistics are taken over."""

    dp = None

    def __init__(self, channels: int, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.ones(channels, **kw))
        self.bias = nn.Parameter(torch.zeros(channels, **kw))
        self.register_buffer("running_mean", torch.zeros(channels, **kw))
        self.register_buffer("running_var", torch.ones(channels, **kw))

    def forward(self, x, train: bool = False):
        xf = x.to(torch.float32)
        if train and self.dp is not None:
            n = xf.new_tensor([float(xf.numel() // xf.shape[1])])
            sums = all_reduce_autograd(torch.cat([xf.sum(dim=(0, 2, 3)), n]),
                                       self.dp)
            count = sums[-1].detach()
            mean = sums[:-1] / count
            dev = xf - mean[None, :, None, None]
            var = all_reduce_autograd((dev * dev).sum(dim=(0, 2, 3)),
                                      self.dp) / count
        elif train:
            mean = xf.mean(dim=(0, 2, 3))
            var = xf.var(dim=(0, 2, 3), unbiased=False)
        if train:
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    mean, alpha=1.0 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    var, alpha=1.0 - BN_MOMENTUM)
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight * torch.rsqrt(var + BN_EPS)
        y = (xf - mean[None, :, None, None]) * scale[None, :, None, None]
        return (y + self.bias[None, :, None, None]).to(x.dtype)


class _Block(nn.Module):
    """What the two block kinds share: the projection of the residual when
    its shape differs from the block's output."""

    def _downsample(self, cin, cout, stride, kw, device):
        if stride != 1 or cin != cout:
            self.downsample = nn.ModuleList([
                Conv2d(cin, cout, 1, stride, **kw), BatchNorm2d(cout, device)])
        else:
            self.downsample = None

    def _residual(self, x, train):
        if self.downsample is None:
            return x
        conv, bn = self.downsample
        return bn(conv(x), train)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, cin, filters, stride=1, groups=1, width_per_group=64,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv1 = Conv2d(cin, filters, 3, stride, 1, **kw)
        self.bn1 = BatchNorm2d(filters, device)
        self.conv2 = Conv2d(filters, filters, 3, 1, 1, **kw)
        self.bn2 = BatchNorm2d(filters, device)
        self._downsample(cin, filters, stride, kw, device)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        return F.relu(y + self._residual(x, train))


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, cin, filters, stride=1, groups=1, width_per_group=64,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        width = int(filters * (width_per_group / 64.0)) * groups
        self.conv1 = Conv2d(cin, width, 1, **kw)
        self.bn1 = BatchNorm2d(width, device)
        self.conv2 = Conv2d(width, width, 3, stride, 1, groups, **kw)
        self.bn2 = BatchNorm2d(width, device)
        self.conv3 = Conv2d(width, filters * 4, 1, **kw)
        self.bn3 = BatchNorm2d(filters * 4, device)
        self._downsample(cin, filters * 4, stride, kw, device)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        return F.relu(y + self._residual(x, train))


class ResNetGrid(nn.Module):
    """``dtype``: the compute dtype; ``param_dtype``: what the convolution
    and ``fc`` weights are stored in (None: the compute dtype)."""

    def __init__(self, embed_dim: int, depth: int = 1, dropout: float = 0.1,
                 img_size: int = 224, dtype: torch.dtype = torch.float32,
                 device=None, param_dtype=None):
        super().__init__()
        kind, stage_sizes, groups, wpg = DEPTHS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.dtype = dtype
        self.dropout = dropout
        pd = dtype if param_dtype is None else param_dtype
        kw = dict(device=device, dtype=pd)
        self.conv1 = Conv2d(3, 64, 7, 2, 3, **kw)
        self.bn1 = BatchNorm2d(64, device)
        cin = 64
        for i, num_blocks in enumerate(stage_sizes):
            blocks = []
            for j in range(num_blocks):
                blocks.append(block(cin, 64 * 2 ** i,
                                    2 if i > 0 and j == 0 else 1, groups,
                                    wpg, **kw))
                cin = 64 * 2 ** i * block.expansion
            setattr(self, f"layer{i + 1}", nn.ModuleList(blocks))
        self.stages = len(stage_sizes)
        self.fc = nn.Linear(cin, embed_dim, bias=False, **kw)
        self.location_embedding = nn.Parameter(torch.zeros(
            ((img_size // 32) ** 2, embed_dim), dtype=torch.float32,
            device=device))

    def forward(self, images, train: bool = False, drop=None):
        """images [B, S, S, 3], normalized, channels last. Returns
        [B, (S/32)^2, embed_dim] in the compute dtype. ``drop`` (a
        ``DropoutRng``) turns the two dropouts on."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)   # NCHW view, no copy
        x = F.relu(self.bn1(self.conv1(x), train))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(self.stages):
            for blk in getattr(self, f"layer{i + 1}"):
                x = blk(x, train)
        B, C = x.shape[:2]
        grid = x.permute(0, 2, 3, 1).reshape(B, -1, C)  # slots row major
        if drop is not None:
            grid = drop.dropout(grid, self.dropout)
        grid = F.linear(grid, self.fc.weight.to(grid.dtype))
        if grid.shape[1] != self.location_embedding.shape[0]:
            raise ValueError(
                f"{grid.shape[1]} grid slots for a location table of "
                f"{self.location_embedding.shape[0]}: the images must be "
                "img_size squared")
        out = grid + self.location_embedding[None].to(grid.dtype)
        if drop is not None:
            out = drop.dropout(out, self.dropout)
        return out
