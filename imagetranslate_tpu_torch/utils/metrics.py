"""Step metrics (port of imagetranslate_tpu/utils/metrics.py): loss per token
and tokens/sec, printed every ``log_every`` steps, plus optional JSONL."""

from __future__ import annotations

import json
import time
from typing import Optional, TextIO

import torch


class StepMeter:
    """``quiet``: count, print nothing (the ranks of a mesh other than 0)."""

    def __init__(self, log_every: int = 50, jsonl: Optional[TextIO] = None,
                 prefix: str = "", quiet: bool = False):
        self.log_every = log_every
        self.jsonl = jsonl
        self.prefix = prefix
        self.quiet = quiet
        self.reset_window()
        self.total_tokens = 0
        self.total_loss = 0.0

    def reset_window(self):
        self.win_tokens = 0
        self.win_loss = 0.0
        self.win_start = time.time()

    def update(self, step: int, sum_loss: float, ntokens: float):
        self.win_tokens += ntokens
        self.win_loss += sum_loss
        self.total_tokens += ntokens
        self.total_loss += sum_loss
        if step % self.log_every == 0 and self.win_tokens > 0 \
                and not self.quiet:
            elapsed = max(time.time() - self.win_start, 1e-9)
            tps = self.win_tokens / elapsed
            loss = self.win_loss / self.win_tokens
            print(f"{self.prefix}step {step} loss {loss:.4f} "
                  f"tokens/sec {tps:.1f}", flush=True)
            if self.jsonl is not None:
                self.jsonl.write(json.dumps(
                    {"step": step, "loss": loss, "tokens_per_sec": tps})
                    + "\n")
                self.jsonl.flush()
            self.reset_window()

    def epoch_loss(self) -> float:
        return self.total_loss / max(self.total_tokens, 1)

    def finish(self, step: int):
        """Hook for subclasses with deferred state; no-op here."""


class AsyncStepMeter(StepMeter):
    """StepMeter that takes DEVICE scalars and defers every device->host
    sync to the log boundary: per step it appends, and once per
    ``log_every`` steps the pending scalars are stacked and fetched in one
    transfer. That transfer waits for every step enqueued so far, so the
    window's tokens/sec is wall-clock throughput, not the enqueue rate."""

    def __init__(self, log_every: int = 50, jsonl=None, prefix: str = "",
                 quiet: bool = False):
        super().__init__(log_every=log_every, jsonl=jsonl, prefix=prefix,
                         quiet=quiet)
        self._pending = []

    def update(self, step: int, sum_loss, ntokens):
        self._pending.append((sum_loss, ntokens))
        if step % self.log_every == 0:
            self._flush(step)

    def _flush(self, step: int):
        if not self._pending:
            return
        stacked = torch.stack([
            torch.stack([torch.as_tensor(l, dtype=torch.float32).reshape(()),
                         torch.as_tensor(n, dtype=torch.float32).reshape(())])
            for l, n in self._pending]).cpu()
        self._pending = []
        super().update(step, float(stacked[:, 0].sum()),
                       float(stacked[:, 1].sum()))

    def finish(self, step: int):
        """Flush any deferred window at epoch end so epoch_loss is exact."""
        self._flush(step)
