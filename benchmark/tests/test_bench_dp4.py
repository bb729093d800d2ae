"""The four-card training cell's kind (``traffic/train_mt_dp4.py``) end to
end on the CPU: its ranks run over gloo (two here, at tiny widths, the
world cut from four), each with its rows of the global batches and rank 0's
clock ending the window; rank 0's first steps hold against the reference
of the global batch with each rank's dropout stream, and the fp8 control
and the fault of half the batch left out do not."""

import copy
import time

import pytest
import torch

import harness
import tiny
from judge import limits

DP = "mt-train-packed-dp4"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_dp(**config) -> harness.Cell:
    cell = copy.deepcopy(harness.load_cell(DP))
    cell.config.update(tiny.TINY_MODEL, **config)
    cell.traffic.update(tiny.TINY_TRAFFIC["mt-train-packed"])
    cell.traffic.update(world=2, mesh="2x1", pairs=240)
    return cell


def test_two_ranks_over_gloo_are_correct():
    cell = tiny_dp()
    out, checks = harness.run_cell(cell, 2 ** 31 + 11, 0.5, False, CPU,
                                   time.time())
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert set(checks) == {"grad_gap", "grad_diff", "delta_gap"}
    assert out["attempted"] > 0 and out["device"]["count"] == 2
    assert {"train_tok_s", "peak_mem_gib", "setup_s"} <= set(out["metrics"])


def test_control_and_half_batch_fail():
    cell = tiny_dp(**tiny.TINY_CONTROL["mt-train-packed"])
    got = harness.kind_module(cell).control(cell, 2 ** 31 + 21, CPU,
                                            faults=True)
    lim = limits(DP)
    assert all(v <= lim[k] for k, v in got["program"].items() if k in lim)
    for arm in ("control_fp8", "half_batch"):
        assert any(v > lim[k] for k, v in got[arm].items() if k in lim), got
