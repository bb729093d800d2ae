"""K2, the projection with top-k and logsumexp (``ops/topk_project.py``):
one call is its range launch and its merge."""

import flops

MODULE = "imagetranslate_tpu_torch.ops.topk_project"
TRACE_NAMES = r"\b(project_topk_ranges|project_topk_merge)\b"

LAUNCHES = {
    "_launch": lambda h, w, b, k: flops.k2(h.shape[0], k, h.shape[1],
                                           w.shape[0]),
}
