"""K6's bound (``kernels/k6.py``) counts each source's encoder K/V once for
all its beams, and a program without the op leaves K6 unread."""

import importlib.util
import math
import os

import pytest
import torch

import flops
import harness
import probes
import readers

BW, FL = flops.HBM_BYTES_PER_S, flops.BF16_FLOPS_PER_S
PATH = os.path.join(harness.HERE, "kernels", "k6.py")


def _call(B, K, S, H=12, D=64, bias=True):
    meta = dict(device="meta", dtype=torch.bfloat16)
    return (torch.empty(B * K, H, D, **meta), torch.empty(B, S, H, D, **meta),
            torch.empty(B, S, H, D, **meta),
            torch.empty(B, 1, 1, S, device="meta") if bias else None, K)


@pytest.mark.parametrize("B,K,S", [(2, 3, 5), (1536, 4, 49), (1000, 4, 32)])
def test_bound_by_hand(B, K, S):
    spec = probes.kernel_specs()["k6"]
    H, D = 12, 64
    nbytes = 2 * B * S * H * D * 2 + 4 * B * S + 2 * B * K * H * D * 2
    want = max(nbytes / BW, 4 * B * K * S * H * D / FL)
    assert math.isclose(spec.LAUNCHES["_launch"](*_call(B, K, S)), want)
    no_bias = 2 * B * S * H * D * 2 + 2 * B * K * H * D * 2
    assert math.isclose(spec.LAUNCHES["_launch"](*_call(B, K, S, bias=False)),
                        max(no_bias / BW, 4 * B * K * S * H * D / FL))


def test_kv_bytes_scale_with_sources_not_beams():
    bound = probes.kernel_specs()["k6"].LAUNCHES["_launch"]
    H, D, S = 12, 64, 49
    qctx = 2 * H * D * 2 / BW            # a beam row's q and ctx
    for B in (256, 1536):
        # Four beams a source cost only their q and ctx over one beam.
        assert math.isclose(bound(*_call(B, 4, S)) - bound(*_call(B, 1, S)),
                            3 * B * qctx)
    assert math.isclose(bound(*_call(1536, 4, S)),
                        6 * bound(*_call(256, 4, S)))


def test_a_program_without_the_op_leaves_k6_unread(monkeypatch):
    """The parent of the op: kernels/k6.py names a module that exists and no
    launch function, so the probe wraps nothing and k6_roofline reads
    None."""
    real = importlib.util.find_spec

    def find_spec(name, *a):
        if name == "imagetranslate_tpu_torch.ops.cross_attention":
            return None
        return real(name, *a)

    monkeypatch.setattr(importlib.util, "find_spec", find_spec)
    spec = harness.load_module(PATH, "bench_kernel_k6_parent")
    assert spec.LAUNCHES == {}
    monkeypatch.setattr(probes, "kernel_specs", lambda: {"k6": spec})
    with probes.KernelShapes() as shapes:
        pass
    trace = harness.Trace(0.0, 1.0, [], [])
    assert readers.roofline("k6")({"kernels": shapes.readings(trace)}) is None
