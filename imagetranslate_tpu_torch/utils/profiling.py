"""The program's tracer and the step profiler (port of
imagetranslate_tpu/utils/profiling.py).

The tracer records named host spans and counters from inside the program:

    from imagetranslate_tpu_torch.utils import profiling

    with profiling.span("train.forward"):
        ...
    profiling.count("decode.rows", n)
    if profiling.tracing:            # guard an argument that costs work
        profiling.count("decode.rows_live", costly())
    profiling.count_later("moe.max_load", device_scalar)

``enable()`` turns it on, ``disable()`` off, ``drain()`` returns (and
clears) the closed spans, each ``(name, start_ns, end_ns, parent, thread)``
on ``time.perf_counter_ns``'s clock (``parent``: the name of the span that
was open around it on the same thread, or None; ``thread``: the thread's
native id), and the counters. Spans time the host only: nothing here
synchronises with a device or reads a device value, but ``settle``, which
reads the device scalars ``count_later`` kept (each counter's stacked and
summed on the device, one read a counter): the decode loop settles after
the loop, and ``drain`` settles what is left.

Off (the default), ``span`` costs one check of a module-level flag and
returns one shared object whose ``with`` does nothing; ``count`` costs the
same check. The flag is read at each call, so a ``spanned`` function
records once tracing is on, wherever it was decorated.

``enable()`` anchors the span clock to the wall clock (``time.time_ns``,
the median of a few paired readings). torch.profiler stamps its events on
the wall clock (``trace_start_ns()`` plus each event's microseconds), so a
span maps onto the profiler's clock in one addition: ``profiler_us``.

``StepProfiler`` records a ``torch.profiler`` trace of a few steps of a
training loop into a Chrome trace (``trace_steps_<start>_<stop>.json``,
readable by chrome://tracing, Perfetto or TensorBoard's profiler plugin):
the host's operator calls, on a CUDA card the device's kernels, and the
program's spans of its window.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import threading
import time
from typing import Dict, List, Optional, Tuple

tracing = False
_spans: List[tuple] = []
_counts: Dict[str, float] = {}
_counts_lock = threading.Lock()
_later: Dict[str, list] = {}
_offset_ns = 0
_local = threading.local()


class _Off:
    """The shared span of tracing off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


def _thread():
    """This thread's (open span names, native id): the id is read once a
    thread, as reading it is a system call."""
    st = getattr(_local, "st", None)
    if st is None:
        st = _local.st = ([], threading.get_native_id())
    return st


class _Span:
    __slots__ = ("name", "start", "parent", "stack", "thread")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack, self.thread = _thread()
        self.stack = stack
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.stack.pop()
        _spans.append((self.name, self.start, end, self.parent,
                       self.thread))
        return False


def span(name: str):
    """A context manager that records ``name`` from entry to exit while
    tracing is on."""
    if not tracing:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: each call of the function is a span ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not tracing:
                return fn(*a, **kw)
            with _Span(name):
                return fn(*a, **kw)
        return wrapper
    return deco


def count(name: str, n: float = 1) -> None:
    """Adds ``n`` to the counter ``name`` while tracing is on."""
    if tracing:
        with _counts_lock:
            _counts[name] = _counts.get(name, 0) + n


def count_later(name: str, value) -> None:
    """Keeps the device scalar ``value`` for the counter ``name`` while
    tracing is on, unread until ``settle``."""
    if tracing:
        with _counts_lock:
            _later.setdefault(name, []).append(value)


def settle() -> None:
    """Adds the values ``count_later`` kept to their counters: one device
    read a counter."""
    with _counts_lock:
        later = dict(_later)
        _later.clear()
    if not later:
        return
    import torch

    for name, values in later.items():
        total = float(torch.stack([v.reshape(()).to(torch.float64)
                                   for v in values]).sum())
        with _counts_lock:
            _counts[name] = _counts.get(name, 0) + total


def _anchor(pairs: int = 7) -> int:
    """time_ns - perf_counter_ns: the median over ``pairs`` readings of
    the wall clock between two of the span clock."""
    offsets = []
    for _ in range(pairs):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        offsets.append(wall - (a + b) // 2)
    return int(statistics.median(offsets))


def enable() -> None:
    """Turns tracing on and anchors the span clock to the wall clock."""
    global tracing, _offset_ns
    if not tracing:
        _offset_ns = _anchor()
        tracing = True


def disable() -> None:
    global tracing
    tracing = False


def drain() -> Tuple[List[tuple], Dict[str, float]]:
    """The spans closed since the last drain, in the order they started,
    and the counters (``settle``d); clears both."""
    settle()
    with _counts_lock:
        counts = dict(_counts)
        _counts.clear()
    spans = _spans[:]
    del _spans[:len(spans)]       # spans closed meanwhile stay recorded
    return sorted(spans, key=lambda s: s[1]), counts


def wall_ns(t_ns: int) -> int:
    """A ``perf_counter_ns`` reading on the wall clock (the anchor of the
    last ``enable``)."""
    return t_ns + _offset_ns


def trace_start_ns(prof) -> int:
    """The wall-clock start of a finished ``torch.profiler.profile``, from
    which its events' ``time_range`` counts microseconds."""
    return int(prof.profiler.kineto_results.trace_start_ns())


def profiler_us(t_ns: int, start_ns: int) -> float:
    """A ``perf_counter_ns`` reading on torch.profiler's clock: the
    microseconds since ``start_ns`` (``trace_start_ns(prof)``), as the
    profile's events' ``time_range`` gives them."""
    return (t_ns + _offset_ns - start_ns) / 1e3


class StepProfiler:
    """Traces steps [start, stop).

    Usage:
        prof = StepProfiler(logdir, start=10, stop=15)
        for step in ...:
            ...
            prof.tick(step)
        prof.close()

    ``logdir`` None makes every call a no-op. The tracer is on for the
    window (and off after it), and the exported trace holds the program's
    spans as complete events on the host threads that ran them.
    """

    def __init__(self, logdir: Optional[str], start: int = 10,
                 stop: int = 15):
        self.logdir = logdir
        self.start = start
        self.stop = stop
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def trace_path(self) -> str:
        return os.path.join(self.logdir,
                            f"trace_steps_{self.start}_{self.stop}.json")

    def tick(self, step: int):
        if self.logdir is None:
            return
        if not self.active and step == self.start:
            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self.logdir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            enable()
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        elif self.active and step >= self.stop:
            self._finish()

    def _finish(self):
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        disable()
        spans, _ = drain()
        path = self.trace_path()
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        base = int(trace.get("baseTimeNanoseconds", 0))
        pid = os.getpid()
        trace["traceEvents"] += [
            {"ph": "X", "cat": "program_span", "name": name, "pid": pid,
             "tid": thread, "ts": (wall_ns(s) - base) / 1e3,
             "dur": (e - s) / 1e3,
             "args": {"parent": parent}}
            for name, s, e, parent, thread in spans]
        with open(path, "w") as f:
            json.dump(trace, f)
        print(f"profiler trace written to {path}", flush=True)

    def close(self):
        """Stops and writes an active trace (a loop that ended, or raised,
        inside the window)."""
        if self.active:
            self._finish()
