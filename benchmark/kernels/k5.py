"""K5, the fused label-smoothed cross-entropy (``ops/xent.py``): the
forward and backward launches over the logits [N, V]."""

import flops

MODULE = "imagetranslate_tpu_torch.ops.xent"
TRACE_NAMES = r"\b(xent_fwd_kernel|xent_bwd_kernel)\b"

LAUNCHES = {
    "_launch_fwd": lambda logits, *rest:
        flops.k5_forward(*logits.shape, logits.element_size()),
    "_launch_bwd": lambda logits, *rest:
        flops.k5_backward(*logits.shape, logits.element_size()),
}
