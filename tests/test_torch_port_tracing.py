"""The port's tracer (``utils/profiling.py``) and the spans and counters the
program records with it, on the CPU at a tiny size.

- off, ``span`` is one shared object and nothing is recorded;
- on, spans nest per thread (each span's parent is the one open around it
  on its own thread) and a worker thread's spans stay on that thread;
- two packed ``MTTrainer`` steps give two ``train.step`` spans, each
  holding ``train.forward``, ``train.backward`` and ``train.optimizer`` in
  that order, and ``data.stage`` on the prefetch thread;
- a beam search gives one ``decode.step`` a ``model.decode_step`` call, one
  ``decode.exit_check`` an ``_all_finished`` call, and ``decode.rows_live``
  equal to its recount from the per-row limits;
- the trained parameters and the decoded beams are bit-equal with tracing
  on and off;
- a span maps onto torch.profiler's clock: a ``record_function`` issued
  inside it lies inside it.
"""

import threading

import numpy as np
import pytest
import torch

from imagetranslate_tpu_torch.data.packing import PackedMTBatcher
from imagetranslate_tpu_torch.decoding import beam
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer
from imagetranslate_tpu_torch.train.weights import (
    random_params,
    state_dict_from_flax,
)
from imagetranslate_tpu_torch.utils import profiling

V = 40


@pytest.fixture(autouse=True)
def _tracer_off():
    """Every case starts and ends with the tracer off and empty, and one
    intra-op thread (the fastest at these sizes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()
    torch.set_num_threads(n)


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def test_off_records_nothing():
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        profiling.count("c", 3)
    assert profiling.drain() == ([], {})


def test_spans_nest_per_thread():
    profiling.enable()

    def work():
        with profiling.span("worker"):
            with profiling.span("worker.inner"):
                pass

    with profiling.span("outer"):
        with profiling.span("inner"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
        profiling.count("n", 2)
        profiling.count("n", 3)
    spans, counts = profiling.drain()
    assert counts == {"n": 5}
    by = {s[0]: s for s in spans}
    main, worker = threading.get_native_id(), t.native_id
    assert by["outer"][3] is None and by["inner"][3] == "outer"
    assert by["worker"][3] is None and by["worker.inner"][3] == "worker"
    assert {by[k][4] for k in ("outer", "inner")} == {main}
    assert {by[k][4] for k in ("worker", "worker.inner")} == {worker}
    assert by["outer"][1] <= by["inner"][1] <= by["inner"][2] <= \
        by["outer"][2]
    assert [s[0] for s in spans] == ["outer", "inner", "worker",
                                     "worker.inner"]


def test_threads_lose_no_span_or_count():
    """More threads than cores record spans and add to one counter, the
    interpreter switching threads every few microseconds: nothing is
    lost."""
    import sys

    profiling.enable()
    n_threads, n = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        together = threading.Barrier(n_threads)

        def work():
            together.wait(timeout=60)       # all alive at once: distinct ids
            for _ in range(n):
                with profiling.span("w"):
                    profiling.count("c", 1)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    spans, counts = profiling.drain()
    assert counts == {"c": n_threads * n}
    assert len(spans) == n_threads * n
    assert len({s[4] for s in spans}) == n_threads
    assert all(s[3] is None for s in spans)


class _Vocab:
    special_tokens = ["<pad>", "<s>", "<unk>", "<mask>", "</s>", "<aa>",
                      "<bb>"]
    languages = {"<aa>": 0, "<bb>": 1}

    def mask_token_id(self):
        return 3


def _train_two_steps(trace: bool):
    cfg = tiny_config(V)
    rng = np.random.RandomState(0)
    ex = [(rng.randint(7, V, rng.randint(3, 9)).tolist(),
           rng.randint(7, V, rng.randint(3, 9)).tolist(), 0, 1)
          for _ in range(16)]
    batcher = PackedMTBatcher(ex, src_budget=24, dst_budget=24,
                              rows_per_batch=4, max_seq_len=16)
    assert len(batcher) == 2
    trainer = MTTrainer(cfg, _Vocab(), params=random_params(cfg, 0),
                        lr=1e-3, warmup=2, seed=1, device="cpu")
    trainer._save = lambda path, step: None
    if trace:
        profiling.enable()
    trainer.train_epoch(0, "unused", mt_batcher=batcher, eval_every=1 << 30,
                        save_every=1 << 30)
    profiling.disable()
    return trainer, profiling.drain()


def test_train_steps_split_into_forward_backward_optimizer(capsys):
    _, (spans, _) = _train_two_steps(trace=True)
    capsys.readouterr()
    main = threading.get_native_id()
    steps = _named(spans, "train.step")
    assert len(steps) == 2 and {s[4] for s in steps} == {main}
    for step in steps:
        inside = [s for s in spans if s[4] == main and s[3] == "train.step"
                  and step[1] <= s[1] and s[2] <= step[2]]
        assert [s[0] for s in inside] == ["train.forward", "train.backward",
                                          "train.optimizer"]
        assert all(a[2] <= b[1] for a, b in zip(inside, inside[1:]))
    stage = _named(spans, "data.stage")
    assert len(stage) == 2 and main not in {s[4] for s in stage}
    assert len(_named(spans, "data.wait")) == 3    # two batches, the end
    assert {s[3] for s in _named(spans, "model.encode")} == {"train.forward"}


def _tiny_decode(monkeypatch, trace: bool):
    cfg = tiny_config(V)
    model = Seq2Seq(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(random_params(cfg, 2), cfg))
    model.eval()
    g = torch.Generator().manual_seed(3)
    B, S, K, L = 3, 6, 2, 16
    src = torch.randint(7, V, (B, S), generator=g)
    mask = torch.ones(B, S, dtype=torch.bool)
    sizes = torch.tensor([2, 5, 9])
    langs = torch.zeros(B, dtype=torch.long)
    calls = {"exit": 0}
    real = beam._all_finished

    def counted(finished, group):
        calls["exit"] += 1
        return real(finished, group)

    monkeypatch.setattr(beam, "_all_finished", counted)
    if trace:
        profiling.enable()
    enc = model.encode(src, mask, langs)
    best, lengths = beam.beam_search(
        model, enc, mask, torch.full((B,), 6), langs + 1, sizes,
        beam_width=K, max_len=L, max_len_a=1.0, max_len_b=1, eos_id=-1)
    profiling.disable()
    limits = np.minimum(np.floor(sizes.numpy() + 1.0), L)
    return best, lengths, calls["exit"], profiling.drain(), limits, K


def test_beam_search_spans_and_rows(monkeypatch):
    _, _, exits, (spans, counts), limits, K = _tiny_decode(monkeypatch,
                                                           trace=True)
    steps = _named(spans, "decode.step")
    assert len(steps) == len(_named(spans, "model.decode_step")) == \
        len(_named(spans, "decode.select")) == int(limits.max())
    assert {s[3] for s in _named(spans, "model.decode_step")} == \
        {"decode.step"}
    assert len(_named(spans, "decode.exit_check")) == exits == len(steps) + 1
    assert len(_named(spans, "decode.search")) == 1
    assert len(_named(spans, "model.encode")) == 1
    # The separator lies outside the vocabulary: a row is live up to its
    # limit, every beam of it.
    live = sum(K * int((limits >= i + 1).sum())
               for i in range(1, len(steps) + 1))
    assert counts["decode.rows"] == len(steps) * 3 * K
    assert counts["decode.rows_live"] == live < counts["decode.rows"]


@pytest.mark.parametrize("path", ["train", "decode"])
def test_outputs_bit_equal_with_tracing_on_and_off(path, monkeypatch,
                                                   capsys):
    if path == "train":
        off, (none, _) = _train_two_steps(trace=False)
        on, (spans, _) = _train_two_steps(trace=True)
        capsys.readouterr()
        got = dict(on.model.named_parameters())
        for k, p in off.model.named_parameters():
            assert torch.equal(p, got[k]), k
    else:
        b0, l0, _, (none, _), _, _ = _tiny_decode(monkeypatch, trace=False)
        b1, l1, _, (spans, _), _, _ = _tiny_decode(monkeypatch, trace=True)
        assert torch.equal(b0, b1) and torch.equal(l0, l1)
    assert none == [] and spans


def test_spans_map_onto_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    profiling.enable()
    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with profiling.span("outer"):
                with record_function("inner"):
                    x = x @ x / 64
    spans, _ = profiling.drain()
    start = profiling.trace_start_ns(prof)
    inner = sorted(e.time_range.start for e in prof.events()
                   if e.name == "inner")
    inner_end = sorted(e.time_range.end for e in prof.events()
                       if e.name == "inner")
    assert len(spans) == len(inner) == 3
    for (_, s, e, _, _), a, b in zip(spans, inner, inner_end):
        lo = profiling.profiler_us(s, start)
        hi = profiling.profiler_us(e, start)
        assert lo - 50 <= a <= b <= hi + 50, (lo, a, b, hi)
