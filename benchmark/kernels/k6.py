"""K6, the decode cross-attention over deduplicated encoder K/V
(``ops/cross_attention.py``): each source's bf16 K and V read once for all
its beams, the fp32 bias once, q read and ctx written once; 4 operations a
(beam row, position, channel). A program without the op (before it was
written) leaves K6 unread: no launch function is wrapped and its roofline
finds nothing to read."""

import importlib.util

import flops

MODULE = "imagetranslate_tpu_torch.ops.cross_attention"
TRACE_NAMES = r"\bcross_attn_dedup_kernel\b"


def _bound(q, k, v, bias, K):
    R, H, D = q.shape
    B, S = k.shape[:2]
    nbytes = (2 * B * S * H * D * 2 + (0 if bias is None else 4 * B * S)
              + 2 * R * H * D * 2)
    return flops.bound(nbytes, 4.0 * R * S * H * D)


LAUNCHES = {"_launch": _bound}
if importlib.util.find_spec(MODULE) is None:
    MODULE, LAUNCHES = "imagetranslate_tpu_torch.ops", {}
