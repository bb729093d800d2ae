"""The program's own spans (``imagetranslate_tpu_torch/utils/profiling.py``)
on the device trace's clock: which layer's host work the card waits on.

A spans pass is one pass of a cell's traffic (an epoch, or the window's
pass of batches) traced with the device's activity alone while the
program's tracer is on. Its spans map onto the profiler's clock through
the tracer's wall-clock anchor (``profiling.profiler_us``), and every idle
gap of the pass is split among the main thread's innermost open spans,
instant by instant: an idle instant goes to the innermost open span whose
name is one of the path's groups (``TRAIN``, ``DECODE``), or to
``outside``. So the groups' shares add up to the pass's own idle share.

    python3 benchmark/spans.py --workload <cell> --seed <n> [--passes 2]

sets the cell up as ``run.py`` does, then runs ``--passes`` times a
device-only pass (``harness.device_traced``) and a spans pass, the pair's
order turned each time, and prints one JSON line a pair: the readings of
``read`` under the metric names of ``METRICS``, each pass's idle share and
length, and the spans pass's length over the device-only pass's (the
tracer's cost when on). The readers (``idle_share``, ``launches``,
``data_wait_ms``, ``useful_rows``) take ``readings["spans"]`` as ``read``
returns it, so that a metric file of ``metrics/`` can name one of them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Callable, Dict, Optional, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(1, os.path.dirname(HERE))

import harness  # noqa: E402

# Each path's groups: the spans whose idle a metric reads.
TRAIN = ("train.forward", "train.backward", "train.optimizer")
DECODE = ("model.decode_step", "decode.select", "decode.exit_check")
OUTSIDE = "outside"


def spans_traced(fn: Callable[[], None], device):
    """Run ``fn`` under torch.profiler with the device's activity alone and
    the program's tracer on: the ``harness.Trace`` of the pass (as
    ``harness.device_traced`` makes it), the spans on the profiler's clock
    ``(name, start_us, end_us, parent, thread)``, and the counters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from imagetranslate_tpu_torch.utils import profiling

    harness.sync(device)
    profiling.drain()
    profiling.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            harness.sync(device)
            window = time.perf_counter() - t
    finally:
        profiling.disable()
    spans, counts = profiling.drain()
    start = profiling.trace_start_ns(prof)
    kernels = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    t0 = min((k[1] for k in kernels), default=0.0)
    mapped = [(n, profiling.profiler_us(s, start),
               profiling.profiler_us(e, start), p, th)
              for n, s, e, p, th in spans]
    return harness.Trace(t0, t0 + window * 1e6, kernels, []), mapped, counts


def idle_split(trace: "harness.Trace", spans: Sequence[tuple],
               groups: Sequence[str], thread: int) -> Dict[str, float]:
    """Seconds of the trace's idle gaps under each group: at each idle
    instant, the innermost of ``thread``'s open spans whose name is in
    ``groups`` (``OUTSIDE`` where none is). Spans nest on a thread, so the
    innermost open span is the one that started last."""
    wanted = set(groups)
    mine = [s for s in spans if s[4] == thread and s[0] in wanted
            and s[2] > s[1]]
    # Span edges, each closing edge before an opening edge at the same
    # instant; between two edges the open set is constant.
    edges = sorted([(s[1], 1, i) for i, s in enumerate(mine)]
                   + [(s[2], 0, i) for i, s in enumerate(mine)])
    out = {g: 0.0 for g in groups}
    out[OUTSIDE] = 0.0
    gaps = trace.gaps()
    open_: Dict[int, tuple] = {}
    at, j = trace.t0, 0

    def charge(lo: float, hi: float):
        """The idle time in [lo, hi) to the current innermost span."""
        nonlocal j
        if hi <= lo:
            return
        inner = max(open_.values(), key=lambda s: s[1], default=None)
        key = inner[0] if inner else OUTSIDE
        while j < len(gaps) and gaps[j][1] <= lo:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < hi:
            out[key] += (min(hi, gaps[k][1]) - max(lo, gaps[k][0])) * 1e-6
            k += 1

    for t, opening, i in edges:
        t = min(max(t, trace.t0), trace.t1)
        charge(at, t)
        at = max(at, t)
        if opening:
            open_[i] = mine[i]
        else:
            open_.pop(i, None)
    charge(at, trace.t1)
    return out


def read(trace: "harness.Trace", spans: Sequence[tuple],
         counts: Dict[str, float], path: str,
         thread: Optional[int] = None) -> dict:
    """The spans pass's readings (``readings["spans"]``) on ``path``
    (``train`` or ``decode``) for the readers below."""
    if thread is None:
        thread = threading.main_thread().native_id
    groups = TRAIN if path == "train" else DECODE
    step = "train.step" if path == "train" else "decode.step"
    main = [s for s in spans if s[4] == thread]
    t0, t1 = trace.t0, trace.t1
    return {
        "path": path,
        "window_s": trace.window_s,
        "idle_s": trace.window_s - trace.busy_s(),
        "idle": idle_split(trace, spans, groups, thread),
        "kernels": sum(1 for k in trace.kernels if t0 <= k[1] < t1),
        "steps": sum(1 for s in main if s[0] == step),
        "wait_s": sum(s[2] - s[1] for s in main if s[0] == "data.wait")
        * 1e-6,
        "rows": counts.get("decode.rows", 0),
        "rows_live": counts.get("decode.rows_live", 0),
    }


def idle_share(group: str):
    """% of the spans pass in which the card was idle while the host was
    in ``group`` (``OUTSIDE``: in none of the path's groups)."""
    def reader(r):
        s = r.get("spans")
        if not s or not s["window_s"] or group not in s["idle"]:
            return None
        return 100.0 * s["idle"][group] / s["window_s"]
    return reader


def launches(r):
    """Device kernels (and copies) of the spans pass a step (``train.step``
    or ``decode.step`` span)."""
    s = r.get("spans")
    if not s or not s["steps"]:
        return None
    return s["kernels"] / s["steps"]


def data_wait_ms(r):
    """Host ms a step waits in ``data.wait`` (the prefetcher's queue), the
    mean over the spans pass's ``train.step`` spans."""
    s = r.get("spans")
    if not s or s["path"] != "train" or not s["steps"]:
        return None
    return 1e3 * s["wait_s"] / s["steps"]


def useful_rows(r):
    """% of the beam rows of the spans pass's decode steps that were
    neither finished nor past their limit (``decode.rows_live`` over
    ``decode.rows``)."""
    s = r.get("spans")
    if not s or not s["rows"]:
        return None
    return 100.0 * s["rows_live"] / s["rows"]


# The metrics a spans pass reads, by path: name -> reader.
METRICS = {
    "train": {
        "idle_share.train.forward": idle_share("train.forward"),
        "idle_share.train.backward": idle_share("train.backward"),
        "idle_share.train.optimizer": idle_share("train.optimizer"),
        "idle_share.train.outside": idle_share(OUTSIDE),
        "launches.train": launches,
        "data_wait_ms.train": data_wait_ms,
    },
    "decode": {
        "idle_share.decode.model": idle_share("model.decode_step"),
        "idle_share.decode.select": idle_share("decode.select"),
        "idle_share.decode.exit": idle_share("decode.exit_check"),
        "idle_share.decode.outside": idle_share(OUTSIDE),
        "launches.decode": launches,
        "useful_rows.decode": useful_rows,
    },
}


def metrics(readings: dict) -> Dict[str, float]:
    """Every metric of ``METRICS`` on the readings' path that reads a
    number."""
    out = {}
    for name, reader in METRICS[readings["spans"]["path"]].items():
        v = reader(readings)
        if v is not None:
            out[name] = v
    return out


# ---------------- a cell's passes ----------------

def cell_pass(cell, seed: int, device) -> tuple:
    """Set the cell up as its traffic kind's ``run`` does (the trainer's
    checked steps and warm-up, or the decode's warm-up) and return (path,
    one pass of the traffic)."""
    import served

    kind = harness.kind_module(cell)
    name = cell.traffic["kind"]
    if name == "train_mt":
        s = kind.Session(cell, seed, device)
        s.checked_steps()
        s.warm()

        def one():
            s.epoch(kind.Feed(batcher=s.batcher), epoch_seed=seed + 2)
        return "train", one
    s = kind.Session(cell, seed, device)
    if name == "translate":
        s.warm()
        batches = s.batches
    else:
        s.decode(served.Stream(s.pool, s.order[:1]), served.Kept())
        batches = s.pool

    def one():
        s.decode(served.Stream(batches, s.order), served.Kept())
    return "decode", one


def main(argv=None) -> int:
    p = argparse.ArgumentParser("spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--passes", type=int, default=1)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.require_cards(cell.chips)
    import torch

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    path, one = cell_pass(cell, args.seed, device)
    harness.phase("set-up")
    for n in range(args.passes):
        with harness.quiet():
            # In turns, so that the order of the two passes cancels out.
            if n % 2 == 0:
                dev = harness.device_traced(one, device)
            tr, spans, counts = spans_traced(one, device)
            if n % 2 == 1:
                dev = harness.device_traced(one, device)
        got = read(tr, spans, counts, path)
        share = {k: 100.0 * v / got["window_s"]
                 for k, v in got["idle"].items()}
        line = {"workload": cell.name, "seed": args.seed, "pass": n,
                "metrics": metrics({"spans": got}),
                "idle_share.spans_pass": 100.0 * got["idle_s"]
                / got["window_s"],
                "idle_share.device_pass": 100.0 * (
                    1.0 - dev.busy_s() / dev.window_s),
                "sum_of_shares": sum(share.values()),
                "spans_pass_s": got["window_s"],
                "device_pass_s": dev.window_s,
                "on_cost": got["window_s"] / dev.window_s,
                "spans": len(spans), "steps": got["steps"],
                "counts": counts}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
