"""The benchmark's own probes at the calls into the program's layers: each
wraps one entry point for the length of a ``with`` block and restores it.

- ``KernelShapes``: the shapes each hand-written kernel is launched at, and
  the least time of each call. The kernels are the files of ``kernels/``,
  one a kernel, found by name: its module, its launch functions with the
  bound of each call (``flops.py``), and its names in the device trace;
- ``InputWait``: host seconds spent in ``PrefetchIterator.__next__``, the
  training loop's wait for its next staged batch;
- ``BeamTrail``: the beam loop's own numbers (each step's logsumexp and
  selection) for chosen calls of ``beam_search``;
- ``CallCounter``: calls of a bound method (``decode_step``).
"""

from __future__ import annotations

import glob
import importlib
import os
import re
import time
from typing import Dict, Iterable

import harness

KERNELS_DIR = os.path.join(harness.HERE, "kernels")


def kernel_specs() -> Dict[str, object]:
    """Every kernel of ``kernels/``, by its file's name."""
    out = {}
    for path in sorted(glob.glob(os.path.join(KERNELS_DIR, "*.py"))):
        name = os.path.basename(path)[:-3]
        out[name] = harness.load_module(path, "bench_kernel_" + name)
    return out


class KernelShapes:
    """Sums each kernel's per-call bound (seconds) over the calls made
    inside the block."""

    def __init__(self):
        self.specs = kernel_specs()
        self.bound = {k: 0.0 for k in self.specs}
        self.calls = {k: 0 for k in self.specs}

    def __enter__(self):
        self._saved = []
        for key, spec in self.specs.items():
            mod = importlib.import_module(spec.MODULE)
            for attr, bound in spec.LAUNCHES.items():
                orig = getattr(mod, attr)
                self._saved.append((mod, attr, orig))

                def wrapped(*a, _orig=orig, _bound=bound, _key=key, **kw):
                    self.bound[_key] += _bound(*a, **kw)
                    self.calls[_key] += 1
                    return _orig(*a, **kw)

                setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)

    def readings(self, trace) -> Dict[str, tuple]:
        """Every kernel's (summed bound, device seconds in ``trace``)."""
        return {k: (self.bound[k], trace.device_seconds(
            re.compile(spec.TRACE_NAMES).search))
            for k, spec in self.specs.items()}


class InputWait:
    def __init__(self):
        self.seconds, self.calls = 0.0, 0

    def __enter__(self):
        from imagetranslate_tpu_torch.data.prefetch import PrefetchIterator

        self._cls = PrefetchIterator
        self._orig = PrefetchIterator.__next__
        orig = self._orig

        def timed_next(it):
            t = time.perf_counter()
            try:
                return orig(it)
            finally:
                self.seconds += time.perf_counter() - t
                self.calls += 1

        PrefetchIterator.__next__ = timed_next
        return self

    def __exit__(self, *exc):
        self._cls.__next__ = self._orig


class Spans:
    """Host spans (``torch.profiler.record_function``) around the calls
    into the program's layers, so that the trace labels the device's idle
    gaps by what the host was doing: ``targets`` are (object, attribute,
    span name)."""

    def __init__(self, targets):
        self.targets = targets

    def __enter__(self):
        from torch.profiler import record_function

        self._orig = []
        for obj, attr, name in self.targets:
            orig = getattr(obj, attr)
            self._orig.append((obj, attr, orig, attr in vars(obj)))

            def spanned(*a, _orig=orig, _name=name, **kw):
                with record_function(_name):
                    return _orig(*a, **kw)

            setattr(obj, attr, spanned)
        return self

    def __exit__(self, *exc):
        for obj, attr, orig, own in reversed(self._orig):
            if own:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)


class BeamTrail:
    """The beam loop's own numbers for the calls of ``beam_search`` whose
    index (counted from 0 inside the block) is in ``keep``: at each step
    the logsumexp the projection kernel gave each beam row (the third of
    ``decode_step``'s triple, [B*K]) and the selection over the K*K
    candidates (``stable_topk``: the K hypotheses' scores [B, K] and their
    candidates' indices). They stay on the card by reference, with no copy
    and no sync, and are read once the window has closed. Enter it inside
    any other wrapper of ``decode_step``."""

    def __init__(self, model, keep: Iterable[int]):
        self.model, self.keep = model, set(keep)
        self.calls = 0
        self.trails: Dict[int, dict] = {}
        self._cur = None

    def __enter__(self):
        from imagetranslate_tpu_torch.decoding import beam

        self._beam = beam
        search, topk = beam.beam_search, beam.stable_topk
        step = self.model.decode_step
        self._orig = (search, topk, step, "decode_step" in vars(self.model))

        def kept_search(*a, **kw):
            index = self.calls
            self.calls += 1
            if index in self.keep:
                self._cur = {"lse": [], "scores": [], "idx": [], "K": None}
            try:
                return search(*a, **kw)
            finally:
                if self._cur is not None:
                    self.trails[index] = self._cur
                self._cur = None

        def kept_topk(x, k):
            vals, idx = topk(x, k)
            if self._cur is not None:
                self._cur["scores"].append(vals)
                self._cur["idx"].append(idx)
                self._cur["K"] = k
            return vals, idx

        def kept_step(*a, **kw):
            out = step(*a, **kw)
            if self._cur is not None:
                self._cur["lse"].append(out[2])
            return out

        beam.beam_search, beam.stable_topk = kept_search, kept_topk
        self.model.decode_step = kept_step
        return self

    def __exit__(self, *exc):
        search, topk, step, own = self._orig
        self._beam.beam_search, self._beam.stable_topk = search, topk
        if own:
            self.model.decode_step = step
        else:
            delattr(self.model, "decode_step")


class CallCounter:
    """Counts calls of ``obj.name`` (an instance attribute shadows the
    method inside the block)."""

    def __init__(self, obj, name: str):
        self.obj, self.name, self.calls = obj, name, 0

    def __enter__(self):
        orig = getattr(self.obj, self.name)

        def counted(*a, **kw):
            self.calls += 1
            return orig(*a, **kw)

        setattr(self.obj, self.name, counted)
        return self

    def __exit__(self, *exc):
        delattr(self.obj, self.name)
