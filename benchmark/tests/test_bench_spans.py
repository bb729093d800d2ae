"""The program's spans on the device trace's clock (``spans.py``): the idle
split on a synthetic trace, the metrics' names, and on the card the clock
mapping of a kernel launched inside a span."""

import glob
import json
import os
import re
import time

import pytest
import torch

import harness
import spans

MAIN, WORKER = 11, 12


def trace():
    """A 100 us pass: kernels at [10, 20), [40, 50), [70, 80); idle 70 us."""
    kernels = [("k", 10.0, 20.0), ("k", 40.0, 50.0), ("k", 70.0, 80.0)]
    return harness.Trace(0.0, 100.0, kernels, [])


def test_idle_split_innermost_span_wins():
    t = trace()
    s = [("train.step", 5.0, 95.0, None, MAIN),
         ("train.forward", 5.0, 30.0, "train.step", MAIN),
         ("model.encode", 8.0, 25.0, "train.forward", MAIN),
         ("train.backward", 30.0, 60.0, "train.step", MAIN),
         ("train.optimizer", 60.0, 90.0, "train.step", MAIN),
         # A worker thread's span counts for nothing.
         ("train.optimizer", 0.0, 100.0, None, WORKER)]
    got = spans.idle_split(t, s, spans.TRAIN, MAIN)
    us = {k: v * 1e6 for k, v in got.items()}
    # forward [5, 30) idle: [5, 10) + [20, 30); model.encode under it
    # counts as train.forward, the group's innermost span.
    assert us["train.forward"] == pytest.approx(15.0)
    assert us["train.backward"] == pytest.approx(10.0 + 10.0)
    assert us["train.optimizer"] == pytest.approx(10.0 + 10.0)
    # [0, 5) and [90, 100): no group open (train.step is not a group).
    assert us["outside"] == pytest.approx(15.0)
    idle = t.window_s - t.busy_s()
    assert sum(got.values()) == pytest.approx(idle)


def test_idle_split_nested_groups_and_edges():
    """Decode: ``model.decode_step`` and ``decode.select`` inside
    ``decode.step``, the exit check between steps; spans past the pass's
    ends are cut to it."""
    t = trace()
    s = [("decode.search", -50.0, 150.0, None, MAIN),
         ("decode.exit_check", -10.0, 12.0, "decode.search", MAIN),
         ("decode.step", 12.0, 60.0, "decode.search", MAIN),
         ("model.decode_step", 12.0, 35.0, "decode.step", MAIN),
         ("decode.select", 35.0, 60.0, "decode.step", MAIN),
         ("decode.exit_check", 60.0, 72.0, "decode.search", MAIN)]
    got = spans.idle_split(t, s, spans.DECODE, MAIN)
    us = {k: v * 1e6 for k, v in got.items()}
    assert us["decode.exit_check"] == pytest.approx(10.0 + 10.0)
    assert us["model.decode_step"] == pytest.approx(15.0)
    assert us["decode.select"] == pytest.approx(5.0 + 10.0)
    assert us["outside"] == pytest.approx(20.0)
    assert sum(got.values()) == pytest.approx(t.window_s - t.busy_s())


def test_readings_and_metrics():
    t = trace()
    s = [("train.step", 0.0, 50.0, None, MAIN),
         ("train.forward", 0.0, 30.0, "train.step", MAIN),
         ("train.step", 50.0, 100.0, None, MAIN),
         ("data.wait", 50.0, 52.0, "train.step", MAIN),
         ("data.stage", 0.0, 40.0, None, WORKER)]
    r = spans.read(t, s, {}, "train", thread=MAIN)
    m = spans.metrics({"spans": r})
    assert m["launches.train"] == 1.5
    assert m["data_wait_ms.train"] == pytest.approx(1e-3)
    assert m["idle_share.train.forward"] == pytest.approx(20.0)
    assert m["idle_share.train.outside"] == pytest.approx(50.0)
    shares = [v for k, v in m.items() if k.startswith("idle_share.")]
    assert sum(shares) == pytest.approx(70.0)
    d = spans.read(t, [], {"decode.rows": 80, "decode.rows_live": 20},
                   "decode", thread=MAIN)
    md = spans.metrics({"spans": d})
    assert md["useful_rows.decode"] == 25.0
    assert "launches.decode" not in md          # no decode.step span
    assert md["idle_share.decode.outside"] == pytest.approx(70.0)


def test_metric_files_and_span_names():
    """Every file of ``metrics/`` has its ``BENCHMARK.json`` entry, the
    spans' metric names are names the benchmark takes, and every span a
    metric reads is one the program records."""
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    entries = {m["name"] for m in bench["per_layer"]}
    files = {os.path.basename(p)[:-3] for p in
             glob.glob(os.path.join(harness.HERE, "metrics", "*.py"))}
    assert files == entries
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for path, readers in spans.METRICS.items():
        assert all(name.match(n) and n.split(".")[-1] for n in readers)
        assert len(readers) == 6
    source = ""
    for p in glob.glob(os.path.join(harness.ROOT, "imagetranslate_tpu_torch",
                                    "**", "*.py"), recursive=True):
        source += open(p).read()
    for span in spans.TRAIN + spans.DECODE + ("train.step", "decode.step",
                                              "data.wait"):
        assert f'"{span}"' in source, span


@pytest.mark.cuda
def test_a_kernel_inside_a_span_maps_inside_it():
    """A kernel launched inside a span, the card synchronised before the
    span closes, lies inside that span on the profiler's clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    from imagetranslate_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)
    a = torch.randn(2048, 2048, device=dev)
    (a @ a).sum().item()

    def work():
        for i in range(5):
            time.sleep(0.002)       # spans far apart beside the slack
            with profiling.span(f"s{i}"):
                torch.cuda._sleep(20_000)   # ~10 us of device time
                b = a @ a
                del b
                torch.cuda.synchronize(dev)

    tr, mapped, _ = spans.spans_traced(work, dev)
    assert len(mapped) == 5 and len(tr.kernels) >= 10
    slack = 50.0
    for name, s, e, _, _ in mapped:
        assert e - s > 0
    for k, ks, ke in tr.kernels:
        home = [m for m in mapped if m[1] - slack <= ks and ke <= m[2] + slack]
        assert len(home) == 1, (k, ks, ke, mapped)
    # The offset: how far the kernels sit from their spans' edges.
    starts = [min(k[1] for k in tr.kernels if m[1] - slack <= k[1] <= m[2])
              - m[1] for m in mapped]
    print(json.dumps({"first_kernel_after_span_start_us": starts}))
