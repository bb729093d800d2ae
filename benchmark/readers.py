"""The per-layer metrics' arithmetic over a run's readings; each file of
``metrics/`` names one of these as its ``read``. A reader that finds
nothing to read returns None, and the harness leaves the metric out."""

import flops


def fill(r):
    """% of the target slots of the window's batches that carry a real
    token (program counters: the batches' segment ids or masks)."""
    t = r.get("train")
    if not t or not t["slots"]:
        return None
    return 100.0 * t["real_tokens"] / t["slots"]


def input_wait_ms(r):
    """Host ms a step waits in the prefetcher's ``__next__`` for its staged
    batch, the mean over the window's steps (the benchmark's own span at
    the call into the data layer)."""
    t = r.get("train")
    if not t or not t["input_waits"]:
        return None
    return 1e3 * t["input_wait_s"] / t["input_waits"]


def mfu_train(r):
    """% of the card's dense bf16 peak: the model FLOPs of the window's
    steps (``flops.train_flops``: 6 per matmul parameter and real token,
    attention inside each example only, recompute not counted) over the
    window's seconds."""
    t = r.get("train")
    if not t or not t["window_s"]:
        return None
    return 100.0 * t["flops"] / (t["window_s"] * flops.BF16_FLOPS_PER_S)


def mfu_decode(r):
    """% of the card's dense bf16 peak: the model FLOPs of the window's
    answers (encode, the cross-attention's K/V once a source, every beam row
    of every step that served a token: ``served.decode_flops``) over the
    window's seconds."""
    d = r.get("decode")
    if not d or not d["window_s"]:
        return None
    return 100.0 * d["flops"] / (d["window_s"] * flops.BF16_FLOPS_PER_S)


def step_ms_decode(r):
    """The window's ms over its ``decode_step`` calls (counted by wrapping
    the model's ``decode_step``)."""
    d = r.get("decode")
    if not d or not d["steps"]:
        return None
    return 1e3 * d["window_s"] / d["steps"]


def idle_share(r):
    """% of the traced window in which no kernel ran on the card (the
    union of the device intervals over one pass of the window's traffic,
    traced with the device's activity alone)."""
    tr = r.get("trace")
    if tr is None or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def roofline(kernel):
    """% of its roofline a kernel reaches over the traced window: the sum
    of each call's least time (``flops.py``, from the shapes the benchmark
    records at the kernel's launch function) over the device time of the
    kernel's launches in the trace."""
    def read(r):
        k = r.get("kernels", {}).get(kernel)
        if k is None or k[0] <= 0 or k[1] <= 0:
            return None
        return 100.0 * k[0] / k[1]
    return read
