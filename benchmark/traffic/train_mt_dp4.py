"""The ``train_mt_dp4`` traffic kind: ``train_mt``'s packed MT training
(``traffic/train_mt.py``: its session, checked steps, warm-up and window) as
``cli.train_mt --pack --mesh 4x1`` runs it: ``world`` ranks, one process and
one card a rank (``parallel.spawn.run_ranks``; NCCL where each rank has a
card, gloo where they share one), each ``MTTrainer`` on the mesh the mix
names. Every rank builds the same batches of ``rows`` x ``world`` rows and
trains on its ``rows`` of each (``parallel.mesh.host_rows``), and the
gradient is all-reduced over the data group in every step.

Rank 0 decides where the window ends: at the end of each epoch it writes to
a file store whether its clock has passed ``--seconds``, and the other ranks
read it there (from their prefetch threads, outside the process group, whose
collectives belong to the steps). Rank 0 gives the readings and the trace:
``train_tok_s`` is every rank's target tokens (the global batches') over
rank 0's window, ``train_step_ms_p95`` its step-end events, ``peak_mem_gib``
the largest rank's; the per-layer readings are rank 0's own (its rows' fill
and FLOPs, its waits, its kernels and idle time). ``correct`` holds rank 0's
first three steps (the global loss, the all-reduced gradient as Adam holds
it, the replicated change) against the reference's of the global batch
(``reference_dp``): each rank's rows with that rank's dropout stream (the
device generator and the attention seeds shifted by its data index, as
``DropoutRng`` shifts them), the gradient of the summed loss over the global
count, a rank's block of rows at a time.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
import types
from datetime import timedelta

import harness
import judge
import probes

HERE = os.path.dirname(os.path.abspath(__file__))
train_mt = harness.load_module(os.path.join(HERE, "train_mt.py"),
                               "bench_kind_train_mt")


def global_mix(mix: dict) -> dict:
    """The mix as one process's batcher sees it: ``rows`` x ``world`` rows a
    batch."""
    return dict(mix, rows=mix["rows"] * mix["world"])


class AgreedFeed(train_mt.Feed):
    """``train_mt.Feed`` whose epochs end where rank 0's clock says: at an
    epoch's end with a deadline, rank 0 writes its decision under ``tag``
    and the epoch's number to ``store``, and the other ranks read it."""

    def __init__(self, store, rank: int, tag: str, **kw):
        super().__init__(**kw)
        self.store, self.rank, self.tag = store, rank, tag

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
                if self.limit is None and (self.deadline is None
                                           or self._done(epoch)):
                    return
        return gen()

    def _done(self, epoch: int) -> bool:
        key = f"{self.tag}.{epoch}"
        if self.rank == 0:
            done = time.perf_counter() >= self.deadline
            self.store.set(key, "1" if done else "0")
            return done
        return self.store.get(key) == b"1"


class RankSession(train_mt.Session):
    """``train_mt.Session`` on a rank of ``mesh``: the trainer holds the
    mesh, and the batches are the global ones."""

    def __init__(self, cell, seed: int, device, mesh):
        import torch

        from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
        from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer
        from imagetranslate_tpu_torch.train.weights import (
            flax_from_state_dict,
        )
        from vocab import StandInVocab
        from weights import specs_of

        self.cell, self.seed, self.device, self.mesh = cell, seed, device, mesh
        config, mix = cell.config, global_mix(cell.traffic)
        train = config["train"]
        cfg = harness.seq2seq_config(config)
        self.batcher = train_mt.batcher_for(
            mix, train_mt.examples(mix, config, seed))
        self.stats = {id(b): train_mt.batch_stats(b, config)
                      for b in self.batcher.batches}
        with torch.device("meta"):
            self.specs = specs_of(Seq2Seq(cfg, param_dtype=torch.float32))
        w0 = self.weights()
        self.trainer = MTTrainer(
            cfg, StandInVocab(config["vocab_size"]),
            params=flax_from_state_dict(w0, cfg), lr=train["lr"],
            warmup=train["warmup"], clip=train["clip"],
            label_smoothing=train["label_smoothing"], mesh=mesh, seed=seed,
            device=device)
        del w0
        self.trainer._save = lambda path, step: None
        self.order = list(self.batcher.shuffled(seed))
        self.check_batches = self.order[:mix["check_steps"]]
        self.events = None
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
                        train_mt._first_gradient(self.trainer)
                if self.calls == self._check:
                    self._checked["delta"] = train_mt._change_norms(
                        self.trainer, self.weights())
            return state, m

        self.trainer.mt_step = step

    def own_stats(self, b) -> dict:
        """``train_mt.batch_stats`` of this rank's rows of batch ``b``."""
        from imagetranslate_tpu_torch.parallel.mesh import host_rows

        rows = host_rows(b.src.shape[0], self.mesh)
        view = types.SimpleNamespace(**{
            k: getattr(b, k)[rows] for k in ("src", "src_seg", "dst",
                                             "dst_seg")})
        return train_mt.batch_stats(view, self.cell.config)


class RankStream:
    """The reference's ``DropoutStream`` as data rank ``d`` draws it: the
    device generator seeded with the host's seed + d, each attention seed
    + d."""

    def __init__(self, host, device, rate: float, attn_rate: float, d: int):
        import torch

        from reference.model import DropoutStream

        self._base = DropoutStream.__new__(DropoutStream)
        self._base.host, self._base.rate = host, rate
        self._base.attn_rate = attn_rate
        self._base.dev = torch.Generator(device=device)
        self._base.dev.manual_seed(self._base.next_seed() + d)
        self.d, self.rate, self.attn_rate = d, rate, attn_rate

    def elementwise(self, x):
        return self._base.elementwise(x)

    def attention(self, B: int, H: int, T: int, S: int, device):
        from reference.philox import keep_mask

        return keep_mask(self.attn_rate, self._base.next_seed() + self.d, B,
                         H, T, S, device)


def reference_dp(cell, s, world: int, prec=None, half_batch: bool = False
                 ) -> dict:
    """``reference/train.py::train_steps`` over the global batches of a
    ``world``-rank data-parallel step: rank d's rows with rank d's dropout
    stream, the gradient of the summed loss over the global count, one
    rank's block of rows at a time; ``half_batch`` leaves out the second
    half of the rows (the fault), ``prec`` the control's precision."""
    import torch

    from reference.model import Seq2SeqRef
    from reference.precision import FP32, set_fp32
    from reference.train import (
        B1,
        B2,
        EPS,
        batch_inputs,
        learning_rate,
        objective,
    )

    set_fp32()
    cfg, device = cell.config, s.device
    train = cfg["train"]
    W0 = s.weights()
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in W0.items()}
    names = list(params)
    mu = {k: torch.zeros_like(v) for k, v in W0.items()}
    nu = {k: torch.zeros_like(v) for k, v in W0.items()}
    host = torch.Generator().manual_seed(int(s.seed))
    model = Seq2SeqRef(params, cfg, prec or FP32)
    losses, grad_norms, grad_vec = [], None, None
    for step, b in enumerate(s.check_batches):
        x = batch_inputs(b, device)
        R = x["src"].shape[0]
        per, kept = R // world, (R // 2 if half_batch else R)
        n = x["loss_mask"][:kept].to(torch.float32).sum().clamp(min=1.0)
        start = host.get_state()
        after = None
        grads = [torch.zeros_like(params[k]) for k in names]
        total_loss = 0.0
        for d in range(world):
            host.set_state(start)
            drop = RankStream(host, device, cfg["dropout"],
                              cfg["attention_dropout"], d)
            lo, hi = d * per, min((d + 1) * per, kept)
            if hi > lo:
                total, _ = objective(model, x, drop,
                                     train["label_smoothing"],
                                     slice(lo, hi))
                g = torch.autograd.grad(total / n,
                                        [params[k] for k in names],
                                        allow_unused=True)
                for acc, gi in zip(grads, g):
                    if gi is not None:
                        acc.add_(gi)
                total_loss += float(total.detach())
            if after is None:
                after = host.get_state()
        host.set_state(after)
        with torch.no_grad():
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
            factor = min(1.0, train["clip"] / float(norm))
            grads = [g * factor for g in grads]
            if step == 0:
                grad_norms = {k: float(g.norm()) for k, g in zip(names, grads)}
                grad_vec = dict(zip(names, grads))
            t = step + 1
            lr = learning_rate(step, train["lr"], train["warmup"])
            for k, g in zip(names, grads):
                mu[k].mul_(B1).add_(g, alpha=1 - B1)
                nu[k].mul_(B2).addcmul_(g, g, value=1 - B2)
                upd = (mu[k] / (1 - B1 ** t)) / (
                    torch.sqrt(nu[k] / (1 - B2 ** t)) + EPS)
                params[k].sub_(upd, alpha=lr)
        losses.append(total_loss / float(n))
    with torch.no_grad():
        deltas = {k: float((params[k] - W0[k]).norm()) for k in params}
    return {"loss": losses, "grad": grad_norms, "grad_vec": grad_vec,
            "delta": deltas}


def _peak(device) -> int:
    import torch

    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def rank_main(rank: int, cell, seed: int, seconds: float, trace: bool,
              store_path: str, device_type: str, control: str):
    """One rank's run (``control``: "" for the window, else "program" or
    "faults" for ``control``); rank 0 returns the run's readings and
    numbers, the others their peak memory."""
    import torch

    from imagetranslate_tpu_torch.parallel.mesh import parse_mesh

    mix = cell.traffic
    world = mix["world"]
    mesh = parse_mesh(mix["mesh"], device_type)
    device = mesh.device
    store = torch.distributed.FileStore(store_path, world)
    store.set_timeout(timedelta(seconds=600))
    s = RankSession(cell, seed, device, mesh)
    if rank == 0:
        harness.phase(f"{len(s.batcher)} batches of {world} x {mix['rows']} "
                      "rows, the trainers built")
    prog = s.checked_steps()
    if control:
        s.close()
        if rank:
            return {"peak": _peak(device)}
        ref = reference_dp(cell, s, world)
        out = {"program": judge.train_numbers(prog, ref)}
        if control == "faults":
            from reference.precision import FP8

            out["control_fp8"] = judge.train_numbers(
                reference_dp(cell, s, world, prec=FP8), ref)
            out["half_batch"] = judge.train_numbers(
                reference_dp(cell, s, world, half_batch=True), ref)
        return out
    if rank == 0:
        harness.phase("the checked steps")
    s.warm()
    if rank == 0:
        harness.phase("warm-up")

    harness.reset_peak(device)
    feed = AgreedFeed(store, rank, "window", batcher=s.batcher)
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
    step_ms = []
    if cuda:
        marks = [start] + s.events
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    s.events = None
    peak = _peak(device)

    readings, result = {}, {}
    if trace:
        own = [s.own_stats(b) for b in done]
        readings["train"] = {
            "real_tokens": sum(o["real"] for o in own),
            "slots": sum(o["slots"] for o in own),
            "flops": sum(o["flops"] for o in own),
            "window_s": window_s, "steps": steps,
            "input_wait_s": wait.seconds, "input_waits": wait.calls}

        def traced_epoch():
            s.epoch(train_mt.Feed(batcher=s.batcher), epoch_seed=seed + 2)

        def label_steps():
            s.epoch(train_mt.Feed(batcher=s.batcher,
                                  limit=mix["label_steps"]),
                    epoch_seed=seed + 3)

        if rank == 0 and cuda:
            from imagetranslate_tpu_torch.data.prefetch import (
                PrefetchIterator,
            )

            shapes = probes.KernelShapes()
            spans = probes.Spans([
                (s.trainer, "mt_step", "train.mt_step"),
                (PrefetchIterator, "__next__", "data.next_batch")])
            tr = harness.trace_window(traced_epoch, label_steps, device,
                                      shapes, spans)
            readings["trace"] = tr
            readings["kernels"] = shapes.readings(tr)
            result["busy_s"] = tr.busy_s()
            result["trace_window_s"] = tr.window_s
            result["breakdown"] = tr.breakdown()
        elif cuda:
            traced_epoch()
            label_steps()
    if rank:
        s.close()
        return {"peak": peak}
    result.update(window_wall=window_wall, window_s=window_s, steps=steps,
                  tokens=sum(s.stats[id(b)]["loss_tokens"] for b in done),
                  step_ms=step_ms, peak=peak)
    s.close()
    t = time.perf_counter()
    numbers = judge.train_numbers(prog, reference_dp(cell, s, world))
    harness.log(f"the reference took {time.perf_counter() - t:.1f} s")
    return {"result": result, "readings": readings, "numbers": numbers}


def _ranks(cell, seed, seconds, trace, device, control=""):
    """``rank_main`` on every rank of the mix's world (this module by its
    own name, which the spawned processes import)."""
    from imagetranslate_tpu_torch.parallel.spawn import run_ranks

    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    import train_mt_dp4 as me

    with tempfile.TemporaryDirectory() as tmp:
        return run_ranks(me.rank_main, cell.traffic["world"],
                         os.path.join(tmp, "group"),
                         args=(cell, seed, seconds, trace,
                               os.path.join(tmp, "epochs"), device.type,
                               control),
                         device=device.type, timeout=3000.0)


def run(cell, seed: int, seconds: float, trace: bool, device):
    mix = cell.traffic
    outs = _ranks(cell, seed, seconds, trace, device)
    r0 = outs[0]
    res, readings = r0["result"], r0["readings"]
    peak = max([res["peak"]] + [o["peak"] for o in outs[1:]])
    dev = harness.device_record(device, mix["world"])
    dev["memory_peak_bytes"] = peak
    result = {"attempted": res["steps"], "failed": 0, "device": dev,
              "window_wall": res["window_wall"], "window_s": res["window_s"],
              "step_ms": res["step_ms"]}
    metrics = {}
    if not trace:
        metrics[mix["rate_metric"]] = {
            "value": res["tokens"] / res["window_s"], "unit": "tokens/s"}
        if res["step_ms"] and mix.get("p95_metric"):
            metrics[mix["p95_metric"]] = {
                "value": harness.percentile(res["step_ms"], 95),
                "unit": "ms"}
        metrics["peak_mem_gib"] = {"value": peak / 2**30, "unit": "GiB"}
    elif "trace" in readings:
        dev["busy_s"] = res["busy_s"]
        dev["window_s"] = res["trace_window_s"]
        result["breakdown"] = res["breakdown"]
    return result, metrics, readings, r0["numbers"]


def control(cell, seed: int, device, faults: bool) -> dict:
    """The check's readings without a window (``train_mt.control`` on the
    mix's ranks): rank 0's first steps against the fp32 reference of the
    global batch and, with ``faults``, the control (the reference in fp8)
    and the fault of half the batch left out."""
    return _ranks(cell, seed, 0.0, False, device,
                  "faults" if faults else "program")[0]
