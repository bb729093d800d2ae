"""The reduction of a device trace: busy time as the union of kernel
intervals inside the window, the idle gaps, and each gap's host label."""

import pytest

import harness
import readers


def trace():
    kernels = [("k_a", 10.0, 20.0), ("k_b", 15.0, 30.0), ("k_a", 50.0, 60.0),
               ("k_c", 95.0, 120.0)]
    host = [("train.mt_step", 0.0, 100.0), ("aten::mm", 32.0, 45.0),
            ("aten::add", 61.0, 62.0), ("data.next_batch", 62.0, 90.0)]
    return harness.Trace(0.0, 100.0, kernels, host)


def test_busy_is_the_union_inside_the_window():
    t = trace()
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx((20 + 10 + 5) * 1e-6)


def test_gaps_and_their_host_labels():
    t = trace()
    assert t.gaps() == [(0.0, 10.0), (30.0, 50.0), (60.0, 95.0)]
    assert t.host_labels() == ["host: train.mt_step", "host: train.mt_step",
                               "host: train.mt_step"]
    b = t.breakdown()
    assert b["device_ops"] == [["k_c", pytest.approx(25e-6)],
                               ["k_a", pytest.approx(20e-6)],
                               ["k_b", pytest.approx(15e-6)]]
    assert b["idle_gaps"] == [["host: train.mt_step", pytest.approx(65e-6)]]


def test_innermost_op_labels_a_gap():
    t = harness.Trace(0.0, 10.0, [("k", 0.0, 2.0), ("k", 8.0, 10.0)],
                      [("outer", 0.0, 10.0), ("inner", 1.0, 5.0)])
    assert t.host_labels() == ["host: inner"]


def test_roofline_share_needs_both_readings():
    read = readers.roofline("k1")
    assert read({}) is None
    assert read({"kernels": {"k1": (1.0, 0.0)}}) is None
    assert read({"kernels": {"k1": (1.0, 4.0)}}) == 25.0


def test_readers():
    r = {"train": {"real_tokens": 3, "slots": 4, "input_wait_s": 0.5,
                   "input_waits": 10, "flops": 989e12, "window_s": 2.0},
         "decode": {"window_s": 2.0, "steps": 400, "flops": 989e11},
         "trace": trace()}
    assert readers.fill(r) == 75.0
    assert readers.input_wait_ms(r) == 50.0
    assert readers.mfu_train(r) == pytest.approx(50.0)
    assert readers.mfu_decode(r) == pytest.approx(5.0)
    assert readers.step_ms_decode(r) == 5.0
    assert readers.idle_share(r) == pytest.approx(65.0)
    assert readers.fill({}) is None and readers.idle_share({}) is None


def test_idle_gaps_from_the_host_pass():
    """The device-only pass gives the busy time and the device ops; the
    labelled gaps come from the pass that traced the host's ops too."""
    t = trace()
    t.idle_gaps = [["host: data.next_batch", 4e-5]]
    b = t.breakdown()
    assert b["idle_gaps"] == [["host: data.next_batch", 4e-5]]
    assert b["device_ops"][0] == ["k_c", pytest.approx(25e-6)]
