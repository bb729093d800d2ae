"""The ``train_mt`` traffic kind: MT training as ``cli.train_mt`` runs it.

Pairs (``textgen``) are binarized as the CLI's corpus is (sorted by target
length), batched by the program's ``PackedMTBatcher`` (``"layout":
"packed"``, ``--pack``) or ``MTBatcher`` at the CLI's budgets for the MT
stream (half of ``--batch`` and ``--capacity``), and trained by
``MTTrainer.train_epoch``: its prefetch thread, ``mt_step`` and step meter.
The trainer starts from weights made on the card from the seed.

Set-up drives the trainer through its first ``check_steps`` steps on
distinct batches (the window's own call and feed), recording each step's
loss, the first step's gradient as Adam's state holds it and each
parameter's change over the steps, then warms every further batch shape the
window uses. The window trains whole epochs of the mix's batches (each in
the batcher's own shuffled order) until one ends after ``--seconds``, so
every run, whatever its seed, trains the same batch shapes. Once it has
closed and the program's state is freed, the plain reference
(``reference/train.py``) follows the first steps from the same weights,
batches and dropout seeds.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np

import flops
import harness
import judge
import probes
import textgen
from vocab import StandInVocab


class Feed:
    """The trainer's batch stream (``shuffled(seed)``): the batcher's own
    shuffled epochs one after another until an epoch ends at or after
    ``deadline`` (``time.perf_counter``), so that a window trains whole
    epochs and every run the same batches; or a fixed list, or ``limit``
    batches. ``given`` records what it handed out, in order."""

    def __init__(self, batcher=None, fixed=None, deadline=None, limit=None):
        self.batcher, self.fixed = batcher, fixed
        self.deadline, self.limit = deadline, limit
        self.given = []

    def shuffled(self, seed: int):
        def gen():
            epoch = 0
            while True:
                source = (self.fixed if self.fixed is not None
                          else self.batcher.shuffled(seed + epoch))
                for b in source:
                    if self.limit is not None and len(self.given) >= \
                            self.limit:
                        return
                    self.given.append(b)
                    yield b
                epoch += 1
                if self.limit is None and (
                        self.deadline is None
                        or time.perf_counter() >= self.deadline):
                    return
        return gen()


def examples(mix: dict, config: dict, seed: int):
    src_len, tgt_len = textgen.paired_lengths(
        mix["pairs"], mix["length"], mix["ratio"], mix["shape_seed"])
    rng = np.random.default_rng(seed)
    a, b = textgen.LANG_TOKENS
    src = textgen.sentences(src_len, a, config["vocab_size"], rng)
    tgt = textgen.sentences(tgt_len, b, config["vocab_size"], rng)
    ex = [(s, t, 0, 1) for s, t in zip(src, tgt)]
    ex.sort(key=lambda e: len(e[1]))        # the binarizer's order
    return ex


def batcher_for(mix: dict, ex):
    if mix["layout"] == "packed":
        from imagetranslate_tpu_torch.data.packing import PackedMTBatcher

        return PackedMTBatcher(ex, pad_id=0, src_budget=mix["row_tokens"],
                               dst_budget=mix["row_tokens"],
                               rows_per_batch=mix["rows"],
                               max_seq_len=mix["max_seq_len"])
    from imagetranslate_tpu_torch.data.loader import MTBatcher

    return MTBatcher(ex, pad_id=0, max_batch=mix["batch"] // 2,
                     capacity_mb=mix["capacity"] // 2,
                     max_seq_len=mix["max_seq_len"],
                     bucket_step=mix["bucket_step"])


def batch_stats(b, config: dict) -> dict:
    """Host counts of one batch: the target tokens the loss reads, the real
    target tokens and the target slots, and the model FLOPs of its step."""
    if hasattr(b, "src_seg"):
        seg = b.dst_seg
        loss_tokens = int(((seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] > 0))
                          .sum())
        real = int((seg > 0).sum())
        src_lens, tgt_lens = [], []
        for r in range(seg.shape[0]):
            s = np.bincount(b.src_seg[r])[1:]
            t = np.bincount(seg[r])[1:]
            src_lens += s[s > 0].tolist()
            tgt_lens += t[t > 0].tolist()
        src_tokens = int((b.src_seg > 0).sum())
    else:
        rows = b.row_mask
        loss_tokens = int((b.dst_mask[:, 1:] & rows[:, None]).sum())
        real = int((b.dst_mask & rows[:, None]).sum())
        src_lens = b.src_mask[rows].sum(1).tolist()
        tgt_lens = b.dst_mask[rows].sum(1).tolist()
        src_tokens = int(sum(src_lens))
    pairs = flops.train_attn_pairs(config, src_lens, tgt_lens)
    return {"loss_tokens": loss_tokens, "real": real,
            "slots": int(b.dst.size),
            "flops": flops.train_flops(config, src_tokens, loss_tokens,
                                       pairs),
            "shape": (b.src.shape, b.dst.shape)}


def _first_gradient(trainer):
    """The first step's gradient as Adam's state holds it (its first
    moment over 1 - b1): the norm of each parameter's, and the gradient
    itself, kept on the host through the window."""
    import torch

    mu = trainer.state.opt_state.mu
    names = list(mu)
    norms = torch.stack(torch._foreach_norm([mu[k] for k in names])) / 0.1
    vec = {k: (mu[k].detach() / 0.1).cpu() for k in names}
    return dict(zip(names, norms.tolist())), vec


def _change_norms(trainer, w0):
    """The norm of each parameter's change from ``w0``."""
    import torch

    params = trainer.state.params
    with torch.no_grad():
        norms = torch.stack([torch.linalg.vector_norm(p.detach() - w0[k])
                             for k, p in params.items()])
    return dict(zip(params, norms.tolist()))


class Session:
    """One trainer from the seed's weights over the mix's batches, its
    ``mt_step`` wrapped to record step ends and the checked steps'
    numbers."""

    def __init__(self, cell, seed: int, device):
        import torch

        from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
        from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer
        from imagetranslate_tpu_torch.train.weights import (
            flax_from_state_dict,
        )
        from weights import specs_of

        self.cell, self.seed, self.device = cell, seed, device
        config, mix = cell.config, cell.traffic
        train = config["train"]
        cfg = harness.seq2seq_config(config)
        self.batcher = batcher_for(mix, examples(mix, config, seed))
        self.stats = {id(b): batch_stats(b, config)
                      for b in self.batcher.batches}
        with torch.device("meta"):
            self.specs = specs_of(Seq2Seq(cfg, param_dtype=torch.float32))
        w0 = self.weights()
        self.trainer = MTTrainer(
            cfg, StandInVocab(config["vocab_size"]),
            params=flax_from_state_dict(w0, cfg), lr=train["lr"],
            warmup=train["warmup"], clip=train["clip"],
            label_smoothing=train["label_smoothing"], seed=seed,
            device=device)
        del w0
        # No checkpoint: train_epoch's epoch-end save is I/O after the
        # window, which no metric reads.
        self.trainer._save = lambda path, step: None
        self.order = list(self.batcher.shuffled(seed))
        self.check_batches = self.order[:mix["check_steps"]]
        self.events = None           # step-end CUDA events, in the window
        self.calls = 0
        self._check = None
        self._checked = {"loss": []}
        real_step = self.trainer.mt_step

        def step(state, batch, rng):
            state, m = real_step(state, batch, rng)
            self.calls += 1
            if self.events is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
            if self._check is not None:
                self._checked["loss"].append(m["sum_loss"] / m["ntokens"])
                if self.calls == 1:
                    self._checked["grad"], self._checked["grad_vec"] = \
                        _first_gradient(self.trainer)
                if self.calls == self._check:
                    self._checked["delta"] = _change_norms(self.trainer,
                                                           self.weights())
            return state, m

        self.trainer.mt_step = step

    def weights(self):
        """The weights the run starts from, made from the seed."""
        from weights import make_weights

        return make_weights(self.specs, self.seed, self.device,
                            self.cell.config["initializer_range"])

    def epoch(self, feed, epoch_seed: int = 0):
        with contextlib.redirect_stdout(sys.stderr):
            self.trainer.train_epoch(0, "unused", mt_batcher=feed,
                                     eval_every=1 << 60, save_every=1 << 60,
                                     epoch_seed=epoch_seed)

    def checked_steps(self) -> dict:
        """The first steps, on distinct batches, through the window's own
        call and feed: each step's loss, the first step's gradient as
        Adam's state holds it, each parameter's change over the steps."""
        self._check = len(self.check_batches)
        self.epoch(Feed(fixed=self.check_batches))
        self._check = None
        if self.calls != len(self.check_batches):
            raise RuntimeError(f"{self.calls} checked steps, want "
                               f"{len(self.check_batches)}")
        return dict(self._checked,
                    loss=[float(x) for x in self._checked["loss"]])

    def warm(self):
        """One step on each batch shape the checked steps did not have,
        and ``warm_steps`` more."""
        stats, n_check = self.stats, len(self.check_batches)
        seen = {stats[id(b)]["shape"] for b in self.check_batches}
        warm = []
        for b in self.order:
            if stats[id(b)]["shape"] not in seen:
                seen.add(stats[id(b)]["shape"])
                warm.append(b)
        warm += self.order[n_check:n_check + self.cell.traffic["warm_steps"]]
        before = self.calls
        self.epoch(Feed(fixed=warm))
        harness.sync(self.device)
        if self.calls - before != len(warm):
            raise RuntimeError(f"warm-up made {self.calls - before} steps, "
                               f"want {len(warm)}")

    def close(self):
        del self.trainer
        harness.free_memory(self.device)


def reference(cell, session: Session, prec=None, half_batch=False) -> dict:
    """The plain reference's three steps from the seed's weights over the
    checked batches (fp32, or ``prec`` for the control; ``half_batch``: the
    fault of half the batch left out)."""
    from reference.precision import FP32, set_fp32
    from reference.train import train_steps

    set_fp32()
    return train_steps(session.weights(), cell.config,
                       session.check_batches, session.seed, session.device,
                       prec or FP32, half_batch)


def run(cell, seed: int, seconds: float, trace: bool, device):
    import torch

    mix = cell.traffic
    s = Session(cell, seed, device)
    harness.phase(f"{len(s.batcher)} batches, the trainer built")
    prog = s.checked_steps()
    harness.phase("the checked steps")
    s.warm()
    harness.phase("warm-up")

    # The window.
    harness.reset_peak(device)
    feed = Feed(batcher=s.batcher)
    cuda = device.type == "cuda"
    s.events, s.calls = ([] if cuda else None), 0
    with harness.quiet():
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        wait = probes.InputWait() if trace else contextlib.nullcontext()
        window_wall = time.time()
        t0 = time.perf_counter()
        feed.deadline = t0 + seconds
        with wait:
            s.epoch(feed, epoch_seed=seed + 1)
        harness.sync(device)
        window_s = time.perf_counter() - t0
    steps = s.calls
    done = feed.given[:steps]
    stats = s.stats
    tokens = sum(stats[id(b)]["loss_tokens"] for b in done)
    step_ms = []
    if cuda:
        marks = [start] + s.events
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    s.events = None
    dev = harness.device_record(device)

    result = {"attempted": steps, "failed": 0, "device": dev}
    metrics = {}
    readings = {}
    if not trace:
        metrics[mix["rate_metric"]] = {"value": tokens / window_s,
                                       "unit": "tokens/s"}
        if step_ms and mix.get("p95_metric"):
            metrics[mix["p95_metric"]] = {
                "value": harness.percentile(step_ms, 95), "unit": "ms"}
        metrics["peak_mem_gib"] = {"value": dev["memory_peak_bytes"] / 2**30,
                                   "unit": "GiB"}
    else:
        readings["train"] = {
            "real_tokens": sum(stats[id(b)]["real"] for b in done),
            "slots": sum(stats[id(b)]["slots"] for b in done),
            "flops": sum(stats[id(b)]["flops"] for b in done),
            "window_s": window_s, "steps": steps,
            "input_wait_s": wait.seconds, "input_waits": wait.calls}
        if cuda:
            from imagetranslate_tpu_torch.data.prefetch import (
                PrefetchIterator,
            )

            shapes = probes.KernelShapes()
            spans = probes.Spans([
                (s.trainer, "mt_step", "train.mt_step"),
                (PrefetchIterator, "__next__", "data.next_batch")])

            def traced_epoch():
                s.epoch(Feed(batcher=s.batcher), epoch_seed=seed + 2)

            def label_steps():
                s.epoch(Feed(batcher=s.batcher, limit=mix["label_steps"]),
                        epoch_seed=seed + 3)

            tr = harness.trace_window(traced_epoch, label_steps, device,
                                      shapes, spans)
            readings["trace"] = tr
            readings["kernels"] = shapes.readings(tr)
            dev["busy_s"] = tr.busy_s()
            dev["window_s"] = tr.window_s
            result["breakdown"] = tr.breakdown()
    result["window_wall"] = window_wall
    result["window_s"] = window_s
    result["step_ms"] = step_ms

    # The reference, once the program's state is freed.
    s.close()
    t = time.perf_counter()
    numbers = judge.train_numbers(prog, reference(cell, s))
    harness.log(f"the reference took {time.perf_counter() - t:.1f} s")
    return result, metrics, readings, numbers


def control(cell, seed: int, device, faults: bool) -> dict:
    """The check's readings without a window: the program's first steps
    against the fp32 reference and, with ``faults``, the control (the
    reference in fp8) and the fault of half the batch left out, each
    against the same fp32 reference."""
    from reference.precision import FP8

    s = Session(cell, seed, device)
    prog = s.checked_steps()
    s.close()
    ref = reference(cell, s)
    out = {"program": judge.train_numbers(prog, ref)}
    if faults:
        out["control_fp8"] = judge.train_numbers(
            reference(cell, s, prec=FP8), ref)
        out["half_batch"] = judge.train_numbers(
            reference(cell, s, half_batch=True), ref)
    return out
