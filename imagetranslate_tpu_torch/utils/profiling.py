"""Profiling hooks (port of imagetranslate_tpu/utils/profiling.py):
``StepProfiler`` records a ``torch.profiler`` trace of a few steps of a
training loop into a directory, and ``annotate`` names a region of it.

The trace is a Chrome trace (``trace_steps_<start>_<stop>.json``, readable by
chrome://tracing, Perfetto or TensorBoard's profiler plugin); it holds the
host's operator calls and, on a CUDA card, the device's kernels.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional


class StepProfiler:
    """Traces steps [start, stop).

    Usage:
        prof = StepProfiler(logdir, start=10, stop=15)
        for step in ...:
            ...
            prof.tick(step)
        prof.close()

    ``logdir`` None makes every call a no-op.
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
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        elif self.active and step >= self.stop:
            self._finish()

    def _finish(self):
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(self.trace_path())
        print(f"profiler trace written to {self.trace_path()}", flush=True)

    def close(self):
        """Stops and writes an active trace (a loop that ended, or raised,
        inside the window)."""
        if self.active:
            self._finish()


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler's timeline."""
    import torch

    with torch.profiler.record_function(name):
        yield
