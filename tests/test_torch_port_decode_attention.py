"""The port's beam decode attention (imagetranslate_tpu_torch.ops.
decode_attention) against the JAX package's: ``decode_attention_reference``
with row maps equals the Pallas kernel ``windowed_decode_attention`` run in
interpret mode and the extracted XLA path
``reference_windowed_decode_attention`` on the same numpy inputs (fp32 within
1e-5: the same sums in another order; bf16 within 2e-2: one or two bf16 ulps
of outputs of magnitude ~1), and its gather form (no row maps, no window)
equals the plain attention over the masked full buffer that the decode step
otherwise runs. The kernel's gate is a pure function of dtypes and sizes and
is tested without a card, as is the decoder's routing (by dtypes alone off the
CPU, driven on the ``meta`` device with the op recorded); the kernel itself is
held against the plain version on a card by the test marked ``cuda``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.ops import decode_attention as jda
from imagetranslate_tpu_torch.models import transformer as tr
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.ops import decode_attention as da
from imagetranslate_tpu_torch.ops.attention import (
    make_attention_bias,
    plain_attention,
)

FP32_ATOL = 1e-5
BF16_ATOL = 2e-2


def _inputs(B, K, W, H, D, t0, seed):
    rng = np.random.RandomState(seed)
    R = B * K
    q = rng.randn(R, H, D).astype(np.float32)
    mk = rng.randn(R, t0, H, D).astype(np.float32) if t0 else None
    mv = rng.randn(R, t0, H, D).astype(np.float32) if t0 else None
    wk = rng.randn(R, W, H, D).astype(np.float32)
    wv = rng.randn(R, W, H, D).astype(np.float32)
    rowsel = rng.randint(0, K, (B, K)).astype(np.int32)
    wanc = rng.randint(0, K, (B, K, W)).astype(np.int32)
    return q, mk, mv, wk, wv, rowsel, wanc


def _port(arrays, j, dtype=torch.float32):
    q, mk, mv, wk, wv, rowsel, wanc = arrays

    def t(a):
        return None if a is None else torch.tensor(a).to(dtype)

    out = da.decode_attention(t(q), t(mk), t(mv), t(wk), t(wv),
                              torch.tensor(rowsel), torch.tensor(wanc), j)
    assert out.dtype == dtype
    return out.to(torch.float32).numpy()


def _pallas(arrays, j, dtype=jnp.float32):
    q, mk, mv, wk, wv, rowsel, wanc = arrays

    def a(x):
        return None if x is None else jnp.asarray(x, dtype)

    out = jda.windowed_decode_attention(
        a(q), a(mk), a(mv), a(wk), a(wv), jnp.asarray(rowsel),
        jnp.asarray(wanc), j, scale=1.0 / np.sqrt(q.shape[-1]),
        group=min(8, q.shape[0]),
        interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _xla(arrays, j):
    q, mk, mv, wk, wv, rowsel, wanc = arrays
    K = rowsel.shape[1]

    def a(x):
        return None if x is None else jnp.asarray(x)

    out = jda.reference_windowed_decode_attention(
        a(q), a(mk), a(mv), a(wk), a(wv),
        jax.nn.one_hot(rowsel, K, dtype=jnp.float32),
        jax.nn.one_hot(wanc, K, dtype=jnp.float32), j,
        scale=1.0 / np.sqrt(q.shape[-1]), compute_dtype=jnp.float32)
    return np.asarray(out)


# (B, K, W, H, D, t0, j): window only, an unaligned prefix (44 is the first
# consolidation of the JAX decode), the first and the last window slot,
# several batches, another head width.
CASES = [
    (2, 4, 5, 2, 64, 0, 3),
    (2, 4, 5, 2, 64, 44, 2),
    (2, 4, 5, 2, 64, 8, 0),
    (2, 4, 5, 2, 64, 8, 4),
    (4, 4, 5, 2, 64, 11, 3),
    (2, 2, 6, 4, 32, 8, 3),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_reference_matches_pallas_interpret_and_xla_path(case):
    *shape, j = case
    arrays = _inputs(*shape, seed=sum(case))
    got = _port(arrays, j)
    np.testing.assert_allclose(got, _pallas(arrays, j), atol=FP32_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got, _xla(arrays, j), atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("case", [CASES[0], CASES[1]],
                         ids=lambda c: "-".join(map(str, c)))
def test_reference_matches_pallas_interpret_bf16(case):
    *shape, j = case
    arrays = _inputs(*shape, seed=3)
    np.testing.assert_allclose(_port(arrays, j, torch.bfloat16),
                               _pallas(arrays, j, jnp.bfloat16),
                               atol=BF16_ATOL, rtol=0)


def test_optional_row_maps_are_identity():
    """Without a map a part reads the query's own row: the same numbers as
    the identity map, part by part."""
    B, K, W, H, D, t0, j = 2, 3, 4, 2, 16, 5, 2
    q, mk, mv, wk, wv, rowsel, wanc = (
        None if a is None else torch.tensor(a)
        for a in _inputs(B, K, W, H, D, t0, seed=1))
    ident_rows = torch.arange(K, dtype=torch.int32)[None, :].expand(
        B, K).contiguous()
    ident_win = ident_rows[:, :, None].expand(B, K, W).contiguous()
    full = da.decode_attention(q, mk, mv, wk, wv, ident_rows, ident_win, j)
    assert torch.equal(da.decode_attention(q, mk, mv, wk, wv, j=j), full)
    assert torch.equal(
        da.decode_attention(q, mk, mv, wk, wv, None, ident_win, j), full)
    mixed = da.decode_attention(q, mk, mv, wk, wv, rowsel, None, j)
    want = da.decode_attention(q, mk, mv, wk, wv, rowsel, ident_win, j)
    assert torch.equal(mixed, want)
    # R need not be a multiple of any K when no map is given.
    odd = da.decode_attention(q[:5], mk[:5], mv[:5])
    assert torch.equal(odd, da.decode_attention(q, mk, mv)[:5])


@pytest.mark.parametrize("index", [0, 6, 15])
def test_gather_form_matches_plain_attention_over_masked_buffer(index):
    """What the port's decode step calls: positions 0..index of the row's own
    cache, against the plain attention over all L positions with -10000 on
    the dead ones (atol 1e-6: exp(-10000 - m) is 0 in fp32)."""
    rng = np.random.RandomState(index)
    R, L, H, D = 6, 16, 4, 8
    q = torch.tensor(rng.randn(R, 1, H, D).astype(np.float32))
    # The cache is stored in bf16 and read back in fp32, as the step does.
    k = torch.tensor(rng.randn(R, L, H, D).astype(np.float32)).bfloat16()
    v = torch.tensor(rng.randn(R, L, H, D).astype(np.float32)).bfloat16()
    keep = torch.arange(L) <= index
    bias = make_attention_bias(keep)[None, None, None, :]
    want = plain_attention(q, k.float(), v.float(), bias)
    got = da.decode_attention(q[:, 0], k[:, :index + 1], v[:, :index + 1])
    np.testing.assert_allclose(got.numpy(), want[:, 0].numpy(), atol=1e-6,
                               rtol=0)


def test_gate_and_refusals():
    bf16, f32, f8 = torch.bfloat16, torch.float32, torch.float8_e4m3fn
    assert da.kernel_supported(bf16, bf16, 64, 88)
    assert da.kernel_supported(bf16, bf16, 8, 1)
    assert da.kernel_supported(bf16, bf16, 128, 512)
    assert da.kernel_supported(bf16, bf16, 24, da.MAX_LIVE)
    assert not da.kernel_supported(f32, bf16, 64, 88)    # an fp32 model
    assert not da.kernel_supported(bf16, f32, 64, 88)    # an fp32 cache
    assert not da.kernel_supported(bf16, f8, 64, 88)     # an fp8 cache
    assert not da.kernel_supported(bf16, bf16, 60, 88)   # D % 8
    assert not da.kernel_supported(bf16, bf16, 256, 88)  # D > 128
    assert not da.kernel_supported(bf16, bf16, 64, 0)
    assert not da.kernel_supported(bf16, bf16, 64, da.MAX_LIVE + 1)
    assert da.kernel_dtypes(bf16, bf16)
    assert not da.kernel_dtypes(f32, bf16)
    assert not da.kernel_dtypes(bf16, f32)
    assert not da.kernel_dtypes(bf16, f8)

    q = torch.zeros(4, 2, 8)
    k = torch.zeros(4, 3, 2, 8)
    with pytest.raises(ValueError, match="no live position"):
        da.decode_attention(q)
    with pytest.raises(ValueError, match="needs j"):
        da.decode_attention(q, None, None, k, k)
    with pytest.raises(ValueError, match="outside the window"):
        da.decode_attention(q, None, None, k, k, j=3)
    with pytest.raises(ValueError, match="main_k and main_v"):
        da.decode_attention(q, k[:3], k[:3])
    with pytest.raises(ValueError, match="rowsel must be"):
        da.decode_attention(q, k, k, rowsel=torch.zeros(3, 2,
                                                        dtype=torch.int32))
    with pytest.raises(ValueError, match="needs win_k"):
        da.decode_attention(q, k, k, wanc=torch.zeros(2, 2, 3,
                                                      dtype=torch.int32))


def _meta_decoder(monkeypatch, **kw):
    """A one-layer decoder on the ``meta`` device (not the CPU, so routed as
    the card is) with the op replaced by a recorder."""
    cfg = tiny_config(**{"dec_layers": 1, "decode_attention_impl": "fused",
                         **kw})
    dec = tr.Decoder(cfg, device="meta")
    calls = []

    def recorder(q, k, v):
        calls.append((tuple(q.shape), tuple(k.shape), q.dtype, k.dtype))
        return torch.empty_like(q)

    monkeypatch.setattr(tr, "decode_attention", recorder)
    enc = torch.empty(3, 5, cfg.hidden_size, dtype=cfg.compute_dtype,
                      device="meta")
    return cfg, dec, dec.init_cache(enc, 3, 8), calls


@pytest.mark.parametrize("hidden,heads", [(32, 4), (120, 2), (512, 2)],
                         ids=["D8", "D60", "D256"])
def test_fused_step_off_the_cpu_routes_by_dtypes_alone(monkeypatch, hidden,
                                                       heads):
    """A bf16 model with a bf16 cache always reaches the op, also at a head
    width the kernel refuses (60, 256): the op raises there, the decoder does
    not take the plain attention instead."""
    cfg, dec, cache, calls = _meta_decoder(
        monkeypatch, hidden_size=hidden, num_heads=heads, dtype="bfloat16")
    x = torch.empty(3, 1, hidden, dtype=torch.bfloat16, device="meta")
    assert dec.fused_decode_step(x, cache)
    out = dec.step(x, cache, 2, None)
    assert out.shape == x.shape
    D = hidden // heads
    assert calls == [((3, heads, D), (3, 3, heads, D), torch.bfloat16,
                      torch.bfloat16)]


@pytest.mark.parametrize("kw", [dict(dtype="float32"),
                                dict(dtype="bfloat16",
                                     kv_cache_dtype="float32"),
                                dict(dtype="bfloat16",
                                     kv_cache_dtype="float8_e4m3fn"),
                                dict(dtype="bfloat16",
                                     decode_attention_impl="onehot")],
                         ids=["fp32_model", "fp32_cache", "fp8_cache",
                              "onehot"])
def test_plain_step_off_the_cpu_by_dtype_or_impl(monkeypatch, kw):
    cfg, dec, cache, calls = _meta_decoder(monkeypatch, **kw)
    x = torch.empty(3, 1, cfg.hidden_size, dtype=cfg.compute_dtype,
                    device="meta")
    assert not dec.fused_decode_step(x, cache)
    dec.step(x, cache, 2, None)
    assert calls == []


def test_fused_attention_refuses_more_than_one_query():
    cfg = tiny_config(dec_layers=1, decode_attention_impl="fused")
    dec = tr.Decoder(cfg)
    cache = dec.init_cache(torch.zeros(2, 5, cfg.hidden_size), 2, 8)
    att = dec.decoder.layer[0].attention
    x = torch.zeros(2, 3, cfg.hidden_size)
    with pytest.raises(ValueError, match="one query token"):
        att(x, x, None, cache=cache[0], index=0, fused=True)
    # Without the flag a cache and no bias is the whole buffer, every query.
    assert att(x, x, None, cache=cache[0], index=0).shape == x.shape


@pytest.mark.cuda
def test_kernel_matches_reference_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, K, W, H, D, t0, j in [(64, 4, 44, 12, 64, 44, 43),
                                 (3, 4, 5, 2, 32, 0, 2),
                                 (2, 4, 8, 3, 128, 7, 0)]:
        R = B * K
        q, mk, mv, wk, wv = (
            torch.randn(*s, generator=gen, device="cuda").bfloat16()
            for s in ((R, H, D), (R, t0, H, D), (R, t0, H, D),
                      (R, W, H, D), (R, W, H, D)))
        rowsel = torch.randint(0, K, (B, K), generator=gen, device="cuda",
                               dtype=torch.int32)
        wanc = torch.randint(0, K, (B, K, W), generator=gen, device="cuda",
                             dtype=torch.int32)
        before = da.LAUNCHES
        got = da.decode_attention(q, mk, mv, wk, wv, rowsel, wanc, j)
        torch.cuda.synchronize()
        assert da.LAUNCHES == before + 1
        want = da.decode_attention_reference(q, mk, mv, wk, wv, rowsel,
                                             wanc, j)
        # Both round p to bf16: what is left is the order of the fp32 sums
        # and the output's rounding, two bf16 ulps of the largest value.
        tol = 2.0 ** -7 * want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= tol
