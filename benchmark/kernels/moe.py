"""The MoE bank's expert products without drops (``models/moe.py``:
``expert_product``, one grouped product over the experts' segments of rows
sorted by expert; twice a bank's call, for ``wi`` and for ``wo``): each
call's least time reads the weights of every expert that has rows once and
the rows in and out, bf16, and does 2 N K M operations for N rows. Whatever
implements the product (``torch._grouped_mm`` today, a hand-written kernel
later), the same work. An expert without rows is read by no product, so the
count of those with rows comes from the call's offsets: they are kept on the
device (no sync in the traced pass) and read once, when the sum is first
used (``LazyBound``). A program without the function (before the layout's
dropless path) leaves it unread: no launch function is wrapped and the
roofline finds nothing to read."""

import importlib

import flops

MODULE = "imagetranslate_tpu_torch.models.moe"
# The grouped products' kernels in the device trace: CUTLASS's grouped GEMM
# behind torch._grouped_mm on sm_90 (its name holds GroupProblemShape).
TRACE_NAMES = r"GroupProblemShape"


class LazyBound:
    """A sum of per-call bounds whose weight bytes wait on the device: each
    call's (offsets, weight bytes an expert, other bytes, operations). It
    adds to numbers and to itself, and is read (one stack, one sync) the
    first time it is compared, multiplied or turned into a float."""

    def __init__(self, calls=()):
        self.calls = list(calls)
        self._value = None

    def __add__(self, other):
        if isinstance(other, LazyBound):
            return LazyBound(self.calls + other.calls)
        if other == 0:
            return self
        raise TypeError("a LazyBound adds to 0 or to another")

    __radd__ = __add__

    def __iadd__(self, other):
        if not isinstance(other, LazyBound):
            return self + other
        self.calls += other.calls
        self._value = None
        return self

    def __float__(self):
        if self._value is None:
            import torch

            total = 0.0
            if self.calls:
                hit = torch.stack([(offs.diff(prepend=offs.new_zeros(1)) > 0)
                                   .sum() for offs, *_ in self.calls]).cpu()
                for n, (_, per_expert, other, ops) in zip(hit.tolist(),
                                                          self.calls):
                    total += flops.bound(n * per_expert + other, ops)
            self._value = total
        return self._value

    def __le__(self, other):
        return float(self) <= other

    def __rmul__(self, other):
        return other * float(self)

    __mul__ = __rmul__


def _bound(x, w, offs):
    N, K = x.shape
    M = w.shape[-1]
    size = x.element_size()
    return LazyBound([(offs, K * M * size, N * (K + M) * size,
                       2.0 * N * K * M)])


LAUNCHES = {"expert_product": _bound}
if not hasattr(importlib.import_module(MODULE), "expert_product"):
    LAUNCHES = {}
