"""K1, the fused dropout attention (``ops/train_attention.py``): the
forward and backward launches, each call's least time from
``flops.k1_forward`` / ``flops.k1_backward`` at its shapes."""

import flops

MODULE = "imagetranslate_tpu_torch.ops.train_attention"
TRACE_NAMES = r"\b(attn_fwd|attn_bwd_dq|attn_bwd_dkdv|dbias_reduce)\b"


def _shape(q, k, bias):
    B, T, H, D = q.shape
    return B, T, k.shape[1], H, D, bias.shape[2]


LAUNCHES = {
    "_launch_fwd": lambda q, k, v, bias, *rest:
        flops.k1_forward(*_shape(q, k, bias)),
    "_launch_bwd": lambda q, k, v, bias, *rest:
        flops.k1_backward(*_shape(q, k, bias)),
}
