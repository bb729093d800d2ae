"""K4, the decode attention over the bf16 cache
(``ops/decode_attention.py``), at each call's live length."""

import flops

MODULE = "imagetranslate_tpu_torch.ops.decode_attention"
TRACE_NAMES = r"\bdecode_attn_kernel\b"


def _bound(q, main_k, main_v, win_k, win_v, rowsel, wanc, t0, wlive, K):
    R, H, D = q.shape
    return flops.k4(R, H, D, t0 + wlive)


LAUNCHES = {"_launch": _bound}
