"""The benchmark finds every configuration, cell, traffic kind and per-layer
metric by its name, and BENCHMARK.json keeps to the shape its checker reads."""

import json
import os
import re

import pytest

import harness

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower",
                                                                "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        reader = os.path.join(harness.HERE, "metrics",
                              metric["name"] + ".py")
        assert hasattr(harness.load_module(reader, "m"), "read")
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        moves = e2e[metric["moves"]]
        for cell in metric["workloads"]:
            assert cell in moves.get("workloads", CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = harness.load_cell(name)
    assert cell.chips == 1
    assert harness.kind_module(cell).run
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    from judge import limits

    assert limits(name)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    path = os.path.join(harness.ROOT, config["file"])
    assert config["file"].startswith("benchmark/configs/")
    data = json.load(open(path))
    assert config["reduced"] == []
    cfg = harness.seq2seq_config(data)
    assert (cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            cfg.dec_layers) == (768, 12, 3072, 6)


def test_kernels_load_by_name():
    """Each file of ``kernels/`` names its module's launch functions, and
    every ``<kernel>_roofline`` metric has its kernel's file."""
    import importlib

    import probes

    specs = probes.kernel_specs()
    assert {"k1", "k2", "k4", "k5"} <= set(specs)
    for spec in specs.values():
        mod = importlib.import_module(spec.MODULE)
        assert spec.LAUNCHES and all(callable(getattr(mod, a))
                                     for a in spec.LAUNCHES)
        re.compile(spec.TRACE_NAMES)
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["name"][:-len("_roofline")] in specs
