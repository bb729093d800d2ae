"""How the reference computes its products.

``FP32``: float32 with TF32 off (``set_fp32``), the reference proper.
``FP8``: the control, the step below the configuration's bfloat16: both
operands of every product rounded to float8 e4m3 under a per-tensor scale
(the tensor's largest magnitude mapped to e4m3's 448), the product taken in
float32; in the backward both operands of each product (the incoming
gradient and the saved, rounded operand) are rounded alike. Everything else
(softmax, LayerNorm, the loss) stays float32, so that the control differs
from the reference by the products' precision alone.
"""

from __future__ import annotations

import torch


def set_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _FP32:
    name = "fp32"

    def q(self, x):
        return x

    def linear(self, x, w, b=None):
        y = torch.matmul(self.q(x), self.q(w).t())
        return y if b is None else y + b

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def conv2d(self, x, w, stride, padding):
        return torch.nn.functional.conv2d(self.q(x), self.q(w), None,
                                          stride, padding)


def _round_fp8(x):
    """x rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude mapped to e4m3's 448), back in x's dtype."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands rounded to fp8, and in the backward each
    product's operands (the incoming gradient among them) rounded too."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _round_fp8(a), _round_fp8(b)
        ctx.save_for_backward(a8, b8)
        return torch.matmul(a8, b8)

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _round_fp8(g)
        ga = torch.matmul(g8, b8.transpose(-1, -2))
        gb = torch.matmul(a8.transpose(-1, -2), g8)
        # Sum out the dimensions the operands were broadcast over.
        while ga.dim() > a8.dim():
            ga = ga.sum(0)
        while gb.dim() > b8.dim():
            gb = gb.sum(0)
        return ga, gb


class _FP8(_FP32):
    name = "fp8_e4m3"

    def q(self, x):
        return _round_fp8(x.detach())

    def linear(self, x, w, b=None):
        y = _Fp8Matmul.apply(x, w.t())
        return y if b is None else y + b

    def matmul(self, a, b):
        return _Fp8Matmul.apply(a, b)


FP32 = _FP32()
FP8 = _FP8()
