"""The port's flash attention against the JAX package's, on the CPU.

``flash_attention_reference`` (the CUDA kernel's arithmetic in plain tensor
ops, ``BLOCK_K`` = 128 keys a tile) against JAX ``flash_attention`` run in
Pallas interpret mode, as tests/test_flash_attention.py runs it: fp32 inputs
within atol/rtol 1e-5 (the same function, fp32 sums in another order); bf16
inputs within 2^-6 of the largest output (the JAX kernel takes S <= 2048 as
one tile while the port streams 128 keys at a time, so the un-normalised p is
rounded to bf16 against another running maximum: a few bf16 ulps). The gate, the
dispatch through ``dot_product_attention(use_pallas=True)`` at S = 1024, and
the gradients behind it against JAX's ``custom_vjp`` (2e-4, the tolerance of
tests/test_flash_attention.py). The CUDA kernel is held against its plain
version in the ``cuda``-marked test, which skips without a card
(``chip_smoke.py`` holds it at the serving shapes).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.ops.attention import (
    dot_product_attention as jax_attention,
)
from imagetranslate_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from imagetranslate_tpu_torch.ops import flash_attention as fa
from imagetranslate_tpu_torch.ops.attention import (
    dot_product_attention,
    plain_attention,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """At these sizes one intra-op thread is the fastest, and the file's time
    stays steady when other test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, T, S, H, D, seed, pad_from=None, dtype=np.float32):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal((B, n, H, D)).astype(dtype)
               for n in (T, S, S))
    bias = None
    if pad_from is not None:
        bias = np.zeros((B, 1, 1, S), np.float32)
        for b, start in enumerate(pad_from):
            bias[b, 0, 0, start:] = -10000.0
    return q, k, v, bias


def _both(q, k, v, bias, dtype=None):
    """(JAX kernel in interpret mode, the port's plain version) as fp32
    numpy arrays; ``dtype``: cast q, k, v to bf16 on both sides."""
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (
        jnp.float32, torch.float32)
    want = jax_flash_attention(
        *(jnp.asarray(x).astype(jd) for x in (q, k, v)),
        None if bias is None else jnp.asarray(bias))
    assert want is not None
    got = fa.flash_attention_reference(
        *(torch.tensor(x).to(td) for x in (q, k, v)),
        None if bias is None else torch.tensor(bias))
    assert got.dtype == td
    return (np.asarray(want.astype(jnp.float32)), got.float().numpy())


@pytest.mark.parametrize("case", [
    dict(B=2, T=32, S=32, H=2, D=16, pad_from=(32, 20)),     # padding bias
    dict(B=2, T=32, S=32, H=2, D=16),                        # no bias
    dict(B=1, T=64, S=256, H=2, D=16, pad_from=(200,)),      # two K/V tiles
    dict(B=2, T=16, S=128, H=1, D=16, pad_from=(128, 100)),  # T != S
    dict(B=2, T=8, S=128, H=2, D=8, pad_from=(90, 0)),       # a padded row
    # S crosses the 128-key tile raggedly, T the 128-query tile.
    dict(B=1, T=136, S=200, H=2, D=32, pad_from=(170,)),
], ids=["bias", "nobias", "tiles", "t_ne_s", "all_padded", "ragged_tile"])
def test_reference_matches_jax_kernel(case):
    want, got = _both(*_inputs(seed=3, **case))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_reference_matches_jax_kernel_bf16():
    q, k, v, bias = _inputs(2, 32, 256, 2, 16, seed=4, pad_from=(256, 130))
    want, got = _both(q, k, v, bias, dtype="bf16")
    assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()


def test_reference_matches_jax_kernel_bf16_ragged_tile():
    """S = 200 crosses the 128-key tile raggedly, T = 136 the 128-query
    tile; the tolerance of the bf16 case above."""
    q, k, v, bias = _inputs(1, 136, 200, 2, 32, seed=9, pad_from=(170,))
    want, got = _both(q, k, v, bias, dtype="bf16")
    assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()


def test_reference_takes_ragged_tiles():
    """S and T that no tile divides (the JAX gate wants T % 8 == 0 and
    S % 128 == 0 above 2048; the port's does not): against the plain
    attention, fp32, 1e-5."""
    q, k, v, bias = (torch.tensor(x) for x in _inputs(
        2, 13, 77, 2, 8, seed=5, pad_from=(77, 40)))
    assert fa.flash_supported(q, k, bias)
    np.testing.assert_allclose(
        fa.flash_attention(q, k, v, bias).numpy(),
        plain_attention(q, k, v, bias).numpy(), atol=1e-5, rtol=1e-5)


def test_gate():
    q, k, v, bias = (torch.tensor(x) for x in _inputs(
        2, 16, 64, 2, 16, seed=6, pad_from=(64, 30)))
    assert fa.flash_supported(q, k, bias)            # fp32 passes on the CPU
    assert fa.flash_supported(q, k, None)
    assert fa.flash_supported(q.bfloat16(), k.bfloat16(), bias)
    assert not fa.flash_supported(q, k, bias.expand(2, 1, 16, 64))  # T extent
    assert not fa.flash_supported(q, k, bias.expand(2, 2, 1, 64))   # H extent
    assert not fa.flash_supported(q, k, bias[:, :, :, :32])
    assert not fa.flash_supported(q[:, :7], k, bias)                # T < 8
    assert not fa.flash_supported(q[..., :12], k[..., :12], bias)   # D % 8
    with pytest.raises(ValueError, match="flash_supported"):
        fa.flash_attention(q[:, :7], k, v, bias)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"), None)
    # The card's gate, asked without a card: bf16 and the kernel's head dims
    # pass, fp32 and other head dims take the plain attention.
    def on_card(dtype, D=64):
        probe = SimpleNamespace(shape=(2, 16, 2, D), dtype=dtype,
                                device=SimpleNamespace(type="cuda"))
        return fa.flash_supported(probe, probe, None)

    assert on_card(torch.bfloat16)
    assert not on_card(torch.float32)
    assert on_card(torch.bfloat16, 128) and not on_card(torch.bfloat16, 16)


def test_dispatch_matches_jax_at_s_1024():
    """use_pallas + deterministic + S >= 1024 goes through the flash path in
    both packages; below 1024, and with dropout on, it does not."""
    q, k, v, bias = _inputs(1, 16, 1024, 1, 16, seed=7, pad_from=(1000,))
    want = jax_attention(*(jnp.asarray(x) for x in (q, k, v)),
                         jnp.asarray(bias), use_pallas=True)
    tq, tk, tv, tb = (torch.tensor(x) for x in (q, k, v, bias))
    calls = []
    real = fa._FlashAttention.apply

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)

    fa._FlashAttention.apply = counted
    try:
        got = dot_product_attention(tq, tk, tv, tb, use_pallas=True)
        assert len(calls) == 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        # No bias: the kernel's no-bias variant, where JAX passes zeros.
        got = dot_product_attention(tq, tk, tv, None, use_pallas=True)
        want = jax_attention(*(jnp.asarray(x) for x in (q, k, v)), None,
                             use_pallas=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        assert len(calls) == 2
        dot_product_attention(tq, tk[:, :1023], tv[:, :1023],
                              tb[..., :1023], use_pallas=True)
        dot_product_attention(tq, tk, tv, tb, use_pallas=False)
        dot_product_attention(tq, tk, tv, tb, dropout_rate=0.1,
                              deterministic=False, seed=1, use_pallas=True)
        dot_product_attention(tq, tk, tv, tb.expand(1, 1, 16, 1024),
                              use_pallas=True)
        assert len(calls) == 2
    finally:
        fa._FlashAttention.apply = real


def test_gradients_through_dispatch_match_jax():
    """The case of tests/test_flash_attention.py::test_grad_through_flash_path
    on identical numpy inputs: d/d(q, k, v) of sum(out^2) through the
    dispatch, against JAX's custom_vjp, 2e-4; the bias gets no gradient."""
    q, k, v, bias = _inputs(1, 16, 1024, 1, 16, seed=8, pad_from=(1000,))

    def jax_loss(q, k, v):
        out = jax_attention(q, k, v, bias=jnp.asarray(bias), use_pallas=True)
        return jnp.sum(out ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    tb = torch.tensor(bias, requires_grad=True)
    out = dot_product_attention(*leaves, tb, use_pallas=True)
    grads = torch.autograd.grad((out ** 2).sum(), leaves + [tb],
                                allow_unused=True)
    assert grads[3] is None
    for a, b in zip(grads[:3], want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4,
                                   rtol=2e-4)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """On a card: the kernel against its plain version at ragged shapes, with
    and without a bias, D in {32, 64, 128}, within 2^-7 of the largest output
    (two bf16 ulps: the same arithmetic, another exp and another summation
    order); two launches bit-equal; fp32 on the card takes the plain
    attention by the gate."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (sm_90): the CUDA kernel "
                    "has no interpret mode")
    before = fa.LAUNCHES
    cases = 0
    for B, T, S, H, D in ((2, 64, 1024, 2, 64), (1, 100, 1100, 3, 32),
                          (2, 8, 1500, 1, 128), (1, 77, 70, 2, 64),
                          # ragged around the 128-query and 128-key tiles
                          (2, 129, 1087, 3, 128), (1, 8, 1025, 2, 32)):
        for has_bias in (True, False):
            q, k, v, bias = _inputs(B, T, S, H, D, seed=cases,
                                    pad_from=(S // 2,) * B if has_bias
                                    else None)
            q, k, v = (torch.tensor(x).cuda().bfloat16() for x in (q, k, v))
            bias = None if bias is None else torch.tensor(bias).cuda()
            got = fa.flash_attention(q, k, v, bias)
            torch.cuda.synchronize()
            want = fa.flash_attention_reference(q, k, v, bias)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= 2.0 ** -7 * want.float().abs().max().item()
            cases += 1
    assert fa.LAUNCHES - before == cases
    # No atomics and a fixed key order: two launches give the same bits.
    assert torch.equal(fa.flash_attention(q, k, v, bias),
                       fa.flash_attention(q, k, v, bias))
    cases += 2
    q32, k32, v32 = q.float(), k.float(), v.float()
    assert not fa.flash_supported(q32, k32, None)
    assert torch.equal(
        dot_product_attention(q32, k32, v32, None, use_pallas=True),
        plain_attention(q32, k32, v32, None))
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention(q32, k32, v32, None)
    assert fa.LAUNCHES - before == cases
