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


# Shapes the plan must take: the decode paths' (R, H, D, n) at every n they
# launch, few and long rows, the gate's edges, odd head counts and widths.
PLAN_SHAPES = (
    [(R, 12, 64, n, 0) for R in (256, 768, 32, 96) for n in range(1, 89)]
    + [(32, 12, 64, 2048, 0), (3, 2, 64, 20000, 0), (2, 12, 64, 40000, 0),
       (1, 3, 128, 57344, 0), (1, 12, 128, 57344, 0), (1, 64, 128, 57344, 0),
       (1, 37, 8, 1, 0), (2, 1, 8, 3, 0), (9, 4, 128, 33, 0),
       (6, 3, 24, 19, 0), (8, 33, 64, 500, 0), (1, 96, 128, 4096, 0),
       (100000, 12, 64, 88, 0), (32, 12, 64, 1800, 251),
       (2, 12, 64, 30000, 10000), (256, 12, 64, 0, 44), (5, 5, 32, 11, 7)])


@pytest.mark.parametrize("shape", PLAN_SHAPES[-23:] + [PLAN_SHAPES[87]],
                         ids=lambda s: "-".join(map(str, s)))
def test_work_plan_properties(shape):
    """What the kernel relies on: each live position owned by exactly one
    block of a cluster of 1, 2, 4 or 8; at most 12 heads a block and a
    divisor of H, at most 12 warps; shared memory within 227 KB; every
    copy's size and offset a multiple of 16 bytes; the ring as deep as the
    limits allow; the scores in the scratch only when they do not fit
    beside a ring of two stages."""
    R, H, D, t0, wlive = shape
    n = t0 + wlive
    plan = da.work_plan(*shape)
    assert plan.clusters in (1, 2, 4, 8)
    ranges = [range(c * plan.per, min((c + 1) * plan.per, n))
              for c in range(plan.clusters)]
    assert all(len(r) > 0 for r in ranges)
    assert [p for r in ranges for p in r] == list(range(n))
    assert H % plan.groups == 0 and H // plan.groups <= da.MAX_HEADS
    hg = H // plan.groups
    seg = hg * D * 2                        # a line of the group's heads
    assert seg % 16 == 0 and (H * D * 2) % 16 == 0
    assert all(g * seg % 16 == 0 for g in range(plan.groups))
    # Whole mma tiles of 16 positions; a ring of 2 .. MAX_DEPTH stages, each
    # with a q area and a pair of barriers, as deep as the limits allow.
    assert plan.spos % 16 == 0 and plan.spos < plan.per + 16
    assert 2 <= plan.depth <= da.MAX_DEPTH
    stage = (plan.spos + 1) * seg + 16
    assert stage % 16 == 0
    warps = hg * plan.wph
    assert warps <= 12 and (hg >= 8 or warps == 8 // hg * hg)
    others = 4 * (2 * warps + 2 * hg) + (
        4 * (warps + hg) * D if plan.clusters > 1 or plan.wph > 1 else 0)
    scores = 4 * hg * plan.per
    assert plan.scratch == (2 * stage + others + scores > da.SMEM_LIMIT)
    assert plan.smem == plan.depth * stage + others + (
        0 if plan.scratch else scores)
    assert plan.smem <= da.SMEM_LIMIT
    deepest = da.MAX_DEPTH if plan.clusters == 1 else min(
        da.MAX_DEPTH, 2 * -(-plan.per // plan.spos))
    assert plan.depth <= max(2, deepest)
    if plan.depth < deepest:
        # One more stage would break a limit: the block's, or two a SM.
        deeper = plan.smem + stage
        assert deeper > da.SMEM_LIMIT or (
            R * plan.groups * plan.clusters > da.SMS
            and deeper > da.HALF_SMEM)
    assert R * plan.groups * plan.clusters < 2 ** 31


def test_work_plan_at_the_paths_and_at_few_long_rows():
    """No split where the decodes run (R = 256, 768, 32, 96 at n <= 88), a
    split where few rows are long, the scratch only past shared memory, and
    every shape of PLAN_SHAPES planned within 227 KB."""
    for shape in PLAN_SHAPES:
        assert da.work_plan(*shape).smem <= da.SMEM_LIMIT
    for R in (256, 768, 32, 96):
        for n in range(1, 89):
            plan = da.work_plan(R, 12, 64, n, 0)
            assert plan.clusters == 1 and plan.groups == 1, (R, n)
            assert not plan.scratch
    assert da.work_plan(32, 12, 64, 2048, 0).clusters > 1
    assert da.work_plan(3, 2, 64, 20000, 0).clusters == 8
    assert not da.work_plan(3, 2, 64, 20000, 0).scratch
    assert da.work_plan(2, 12, 64, 40000, 0).scratch
    assert da.work_plan(1, 64, 128, 57344, 0).groups == 8


def _gate_before(q_dtype, cache_dtype, head_dim, live):
    """The gate as it stood when the kernel took one block per (row, head)."""
    return (q_dtype == torch.bfloat16 and cache_dtype == torch.bfloat16
            and head_dim % 8 == 0 and 8 <= head_dim <= 128
            and 1 <= live <= 57344)


def test_gate_is_no_narrower_than_before():
    bf16 = torch.bfloat16
    lives = [0, 1, 2, 31, 88, 513, 20000, 57343, 57344, 57345]
    for dtypes in ((bf16, bf16), (torch.float32, bf16), (bf16, torch.float32)):
        for D in range(0, 140):
            for live in lives:
                before = _gate_before(*dtypes, D, live)
                assert da.kernel_supported(*dtypes, D, live) == before or (
                    not before)
                if before:
                    # Any H, any R: the plan fits the block and the grid.
                    for R, H in ((1, 1), (3, 12), (768, 12), (1, 100)):
                        assert da.work_plan(R, H, D, live, 0).smem <= (
                            da.SMEM_LIMIT)


def _split_emulation(arrays, j, clusters):
    """The kernel's split in fp32 numpy: each cluster block's range of live
    positions gives its scores and its max; the blocks exchange the maxima,
    then their sums of exp(s - M), sum those in rank order; each block
    rounds p = e / sum to q's dtype (fp32 here), forms its partial ctx, and
    the partials are summed in rank order."""
    q, mk, mv, wk, wv, rowsel, wanc = arrays
    R, H, D = q.shape
    K = rowsel.shape[1]
    t0 = 0 if mk is None else mk.shape[1]
    out = np.zeros((R, H, D), np.float32)
    scale = np.float32(1.0 / np.sqrt(D))
    for r in range(R):
        group = r // K * K
        ks, vs = [], []
        if t0:
            row = group + rowsel.reshape(-1)[r]
            ks.append(mk[row])
            vs.append(mv[row])
        rows = group + wanc.reshape(R, -1)[r, :j + 1]
        ks.append(wk[rows, np.arange(j + 1)])
        vs.append(wv[rows, np.arange(j + 1)])
        k, v = np.concatenate(ks), np.concatenate(vs)        # [n, H, D]
        n = k.shape[0]
        per = -(-n // clusters)
        parts = [slice(c * per, min((c + 1) * per, n))
                 for c in range(clusters)]
        assert (clusters - 1) * per < n
        s = [np.einsum("hd,nhd->hn", q[r], k[p]).astype(np.float32) * scale
             for p in parts]
        m = np.max([x.max(axis=1) for x in s], axis=0)        # [H]
        e = [np.exp(x - m[:, None]) for x in s]
        total = np.zeros(H, np.float32)
        for x in e:
            total = total + x.sum(axis=1, dtype=np.float32)
        ctx = np.zeros((H, D), np.float32)
        for x, p in zip(e, parts):
            ctx = ctx + np.einsum("hn,nhd->hd", x / total[:, None], v[p])
        out[r] = ctx
    return out


# (B, K, W, H, D, t0, j) with at least 8 live positions a row, so that each
# block of a cluster of 8 owns some, as the plan ensures.
SPLIT_CASES = [(2, 4, 9, 2, 64, 44, 8), (4, 4, 5, 2, 64, 11, 3),
               (3, 2, 12, 4, 32, 20, 11)]


@pytest.mark.parametrize("clusters", [1, 2, 4, 8])
@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_split_emulation_matches_reference_and_xla(case, clusters):
    *shape, j = case
    arrays = _inputs(*shape, seed=7 + clusters)
    got = _split_emulation(arrays, j, clusters)
    np.testing.assert_allclose(got, _port(arrays, j), atol=FP32_ATOL, rtol=0)
    np.testing.assert_allclose(got, _xla(arrays, j), atol=FP32_ATOL, rtol=0)


def _meta_decoder(monkeypatch, **kw):
    """A one-layer decoder on the ``meta`` device (not the CPU, so routed as
    the card is) with the op replaced by a recorder (and the cross-attention
    kernel's op, which has no meta version, by a stand-in)."""
    cfg = tiny_config(**{"dec_layers": 1, "decode_attention_impl": "fused",
                         **kw})
    dec = tr.Decoder(cfg, device="meta")
    calls = []

    def recorder(q, k, v):
        calls.append((tuple(q.shape), tuple(k.shape), q.dtype, k.dtype))
        return torch.empty_like(q)

    monkeypatch.setattr(tr, "decode_attention", recorder)
    monkeypatch.setattr(tr, "cross_attention",
                        lambda q, k, v, bias: torch.empty_like(q))
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
