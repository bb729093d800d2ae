"""What every cell of the benchmark shares: finding a cell's files by name,
the card checks, the window's clock, the device trace's reduction, the
guard against the JAX package, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<config>.json``, named by the ``configs`` entry's ``file``) under
a traffic mix (``traffic/<traffic>.json``, whose ``kind`` names the general
code ``traffic/<kind>.py``). A per-layer metric is a reader of its own,
``metrics/<metric>.py``, whose ``read(readings)`` returns a number or None;
a hand-written kernel whose roofline a metric reads is a file of
``kernels/`` (``probes.KernelShapes``). Adding a cell, a mix, a kernel or a
metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "imagetranslate_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def phase(msg: str) -> None:
    """A set-up phase's end, in seconds since the harness was imported."""
    log(f"[setup {time.time() - _IMPORTED:8.3f} s] {msg}")


def process_start() -> float:
    """The process's start on the ``time.time()`` clock (from /proc; the
    harness's import time where /proc does not say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from a file of the benchmark, by path (its name may hold
    dots and dashes)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, its
    traffic mix and the metrics it reports."""
    if bench is None:
        bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have "
                         f"{sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))

    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if mine(m) and m["moves"] in reported]
    return Cell(name, config, traffic, int(w["chips"]), e2e, per_layer)


def kind_module(cell: Cell):
    kind = cell.traffic["kind"]
    return load_module(os.path.join(HERE, "traffic", kind + ".py"),
                       "bench_kind_" + kind)


def read_per_layer(cell: Cell, readings: dict) -> Dict[str, dict]:
    """Each per-layer metric's reader over the run's readings; a reader
    that finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        mod = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                          "bench_metric_" + m["name"].replace(".", "_")
                          .replace("-", "_"))
        value = mod.read(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def seq2seq_config(config: dict, **override):
    """The port's ``Seq2SeqConfig`` from a configuration file (its own keys
    only; ``model``, ``source``, ``train``, ``assumed`` are the
    benchmark's)."""
    from imagetranslate_tpu_torch.models.config import Seq2SeqConfig

    fields = {f.name for f in dataclasses.fields(Seq2SeqConfig)}
    kw = {k: v for k, v in config.items() if k in fields}
    kw.update(override)
    return Seq2SeqConfig(**kw)


# ---------------- the card ----------------

def require_cards(chips: int) -> None:
    """Exit with 3, printing no result, where the cell's cards are not
    there."""
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: torch.cuda.is_available() is false; the "
            "benchmark measures on the card only")
        raise SystemExit(3)
    if torch.cuda.device_count() < chips:
        log(f"the cell asks for {chips} cards, torch sees "
            f"{torch.cuda.device_count()}")
        raise SystemExit(3)


def device_record(device, chips: int = 1) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


@contextlib.contextmanager
def quiet():
    """The measured window without the host noise the benchmark itself
    controls: Python's cyclic garbage collector runs before it and is held
    off inside it."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def free_memory(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (compared whole: the port's name only begins with it)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100), linear between closest ranks."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ---------------- the device trace ----------------

@dataclasses.dataclass
class Trace:
    """The device kernels (name, start, end; microseconds on the profiler's
    clock) inside the traced window [t0, t1], and the host spans and ops
    (name, start, end) that the idle gaps are labelled by. ``idle_gaps``:
    the breakdown's labelled gaps where they come from another pass."""
    t0: float
    t1: float
    kernels: List[tuple]
    host: List[tuple]
    idle_gaps: Optional[list] = None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_s(self) -> float:
        busy, end = 0.0, self.t0
        for s, e in sorted((max(k[1], self.t0), min(k[2], self.t1))
                           for k in self.kernels):
            if e > max(s, end):
                busy += e - max(s, end)
                end = e
        return busy * 1e-6

    def gaps(self) -> List[tuple]:
        """(start, end) of every interval of the window with no kernel."""
        out, end = [], self.t0
        for s, e in sorted((k[1], k[2]) for k in self.kernels):
            if s > end:
                out.append((end, min(s, self.t1)))
            end = max(end, e)
        if end < self.t1:
            out.append((end, self.t1))
        return [(s, e) for s, e in out if e > s]

    def device_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for n, s, e in self.kernels if match(n)) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for n, s, e in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
        if self.idle_gaps is not None:
            return {"device_ops": [[n[:160], t] for n, t in ops],
                    "idle_gaps": self.idle_gaps}
        labelled: Dict[str, float] = {}
        for (s, e), label in zip(self.gaps(), self.host_labels()):
            labelled[label] = labelled.get(label, 0.0) + (e - s) * 1e-6
        gaps = sorted(labelled.items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[n[:160], t] for n, t in ops],
                "idle_gaps": [[n[:160], t] for n, t in gaps]}

    def host_labels(self) -> List[str]:
        """For each idle gap, the innermost (shortest) host span or op
        running at its start: one sweep over the host events in the order
        they start, keeping those still open."""
        host = sorted(self.host, key=lambda h: h[1])
        out, active, j = [], [], 0
        for start, _ in self.gaps():
            while j < len(host) and host[j][1] <= start:
                active.append(host[j])
                j += 1
            active = [h for h in active if h[2] > start]
            inner = min(active, key=lambda h: h[2] - h[1], default=None)
            out.append("host: " + (inner[0] if inner else "outside any op"))
        return out


def trace_window(fn: Callable[[], None], label: Callable[[], None], device,
                 shapes, spans) -> Trace:
    """Trace ``fn`` (one pass of the window's traffic) with the device's
    activity alone, inside ``shapes`` (the kernels' bounds): the busy time,
    the window (the host clock around ``fn`` and a synchronise) and the
    kernels' device times come from this pass, since tracing the host's
    ops lengthens the host's work and so the idle share. Then trace
    ``label`` (the first steps or batches of such a pass) with the host's
    ops too, inside ``spans`` (host spans at the layers): its idle gaps,
    each labelled by the host op open at its start, go into the
    breakdown."""
    with shapes:
        dev = device_traced(fn, device)
    with spans:
        hosted = traced(label, device)
    dev.idle_gaps = hosted.breakdown()["idle_gaps"]
    return dev


def device_traced(fn: Callable[[], None], device) -> Trace:
    """Run ``fn`` under torch.profiler with the device's activity alone;
    the window is the host clock's length of ``fn`` and a synchronise,
    from the first kernel's start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        sync(device)
        window = time.perf_counter() - t
    kernels = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    t0 = min((k[1] for k in kernels), default=0.0)
    return Trace(t0, t0 + window * 1e6, kernels, [])


def traced(fn: Callable[[], None], device) -> Trace:
    """Run ``fn`` under torch.profiler (host ops and device kernels) and
    reduce its trace to the window that ``fn`` spans."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        with record_function("bench.window"):
            fn()
            sync(device)
    events = prof.events()
    win = [e for e in events if e.name == "bench.window"]
    if not win:
        raise RuntimeError("the profiler lost the window's own span")
    t0, t1 = win[0].time_range.start, win[0].time_range.end
    kernels, host = [], []
    for e in events:
        tr = (e.name, e.time_range.start, e.time_range.end)
        if getattr(e, "is_user_annotation", False) and \
                e.device_type == DeviceType.CUDA:
            continue        # a host span's image on the device's timeline
        if e.device_type == DeviceType.CUDA:
            if tr[2] > t0 and tr[1] < t1:
                kernels.append(tr)
        elif e.name != "bench.window":
            host.append(tr)
    return Trace(t0, t1, kernels, host)


# ---------------- the result ----------------

def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             started: float):
    """One run of the cell past the card checks: the result line (without
    ``correct``) and the compared numbers beside their limits."""
    from judge import held, limits

    result, metrics, readings, numbers = kind_module(cell).run(
        cell, seed, seconds, trace, device)
    if trace:
        metrics = read_per_layer(cell, readings)
    else:
        metrics["setup_s"] = {"value": result["window_wall"] - started,
                              "unit": "s"}
    out = {"correct": False, "attempted": result["attempted"],
           "failed": result["failed"], "metrics": metrics,
           "device": result["device"]}
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    import flops

    card = flops.card_note() if device.type == "cuda" else "cpu"
    log(f"[{cell.name}] seed {seed}: window {result['window_s']:.3f} s; "
        + ", ".join(f"{k} {v['value']!r} {v['unit']}"
                    for k, v in metrics.items()) + f" ({card})")
    checks = held(numbers, limits(cell.name))
    for k, v in numbers.items():
        if k not in checks:
            log(f"read, not compared: {k} {v!r}")
    return out, checks


def finish(result: dict, checks: Dict[str, dict]) -> int:
    """Print each compared number beside its limit (the last lines of
    standard error), then the result line with the checks last; return the
    exit code. ``checks``: name -> {"value", "limit"}; a check holds where
    value <= limit."""
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: the benchmark measures the PyTorch port "
            "and must not load JAX or the JAX package")
        return 4
    for c in checks.values():
        if not math.isfinite(c["value"]):
            c["value"] = 1e300       # no reading: a JSON number, and fails
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    result["correct"] = bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0
