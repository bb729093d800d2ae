"""The decode step's cross-attention over deduplicated encoder K/V
(``ops/cross_attention.py``, the JAX ``Attention.cross_step_dedup``).

On the CPU: the op's plain version against the plain attention on K/V
repeated per beam; the beam searches' tokens and lengths against the path
that repeats the encoder states per beam (the decoder before the
deduplication); the cache's shapes; the decoder's routing on the ``meta``
device. ``-m cuda`` on an H100: the kernel against the plain version at the
decode paths' shapes, its launch counts in a decode, and its name in the
device trace (JAX-free, so it runs on the card's machine as it is).
"""

import contextlib
import glob
import os
import re

import pytest
import torch

from imagetranslate_tpu_torch.decoding.beam import (
    beam_search,
    beam_search_dual,
)
from imagetranslate_tpu_torch.models import transformer as tr
from imagetranslate_tpu_torch.models.captioning import ImageSeq2Seq
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
from imagetranslate_tpu_torch.models.transformer import pad_bias
from imagetranslate_tpu_torch.ops import cross_attention as xa
from imagetranslate_tpu_torch.ops.attention import plain_attention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32: the K queries of a source are the rows of one product here and K
# products of one row in the plain attention, so the sums over D and over S
# may run in another order: a few fp32 ulps of outputs under 4 in magnitude.
FP32_ATOL = 2e-6


def _inputs(B, K, S, H, D, seed, dtype=torch.float32, device="cpu"):
    """q [B K, H, D], k, v [B, S, H, D] and a padding bias [B, 1, 1, S]: row
    b keeps its first S - b % 3 positions (at least one)."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(*s, generator=gen).to(dtype).to(device)
               for s in ((B * K, H, D), (B, S, H, D), (B, S, H, D)))
    keep = torch.arange(S)[None, :] < torch.tensor(
        [max(1, S - b % 3) for b in range(B)])[:, None]
    return q, k, v, pad_bias(keep.to(device)), keep


def _per_beam(q, k, v, bias):
    """The decoder before the deduplication: the plain attention on K/V and
    bias repeated per beam, one query token a row."""
    K = q.shape[0] // k.shape[0]
    rep = lambda t: t.repeat_interleave(K, dim=0)   # noqa: E731
    return plain_attention(q[:, None], rep(k), rep(v),
                           None if bias is None else rep(bias))[:, 0]


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("H", [6, 12])
@pytest.mark.parametrize("S", [1, 7, 49, 130])
@pytest.mark.parametrize("K", [1, 4, 5])
def test_plain_version_equals_plain_attention_on_repeated_kv(K, S, H, D):
    q, k, v, bias, _ = _inputs(3, K, S, H, D, seed=K * 1000 + S + H + D)
    got = xa.cross_attention(q, k, v, bias)
    assert got.shape == q.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, _per_beam(q, k, v, bias), rtol=0,
                               atol=FP32_ATOL)


def test_plain_version_without_bias_and_in_bf16():
    q, k, v, _, _ = _inputs(2, 4, 9, 4, 16, seed=3)
    torch.testing.assert_close(xa.cross_attention(q, k, v),
                               _per_beam(q, k, v, None), rtol=0,
                               atol=FP32_ATOL)
    q, k, v, bias, _ = _inputs(2, 4, 9, 4, 16, seed=4, dtype=torch.bfloat16)
    got = xa.cross_attention(q, k, v, bias)
    assert got.dtype == torch.bfloat16
    # bf16 products of p and v: the same roundings, sums in another order.
    torch.testing.assert_close(got.float(), _per_beam(q, k, v, bias).float(),
                               rtol=0, atol=2.0 ** -7)


@pytest.mark.parametrize("bad", ["rows", "kv", "bias", "device"])
def test_refuses_what_it_cannot_take(bad):
    q, k, v, bias, _ = _inputs(2, 4, 5, 4, 16, seed=5)
    if bad == "rows":
        args = (q[:7], k, v, bias)
    elif bad == "kv":
        args = (q, k, v[:, :4], bias)
    elif bad == "bias":   # one a beam, as the decoder passed it before
        args = (q, k, v, bias.repeat_interleave(4, dim=0))
    else:   # the kernel's dtypes on a device that has no kernel
        args = tuple(t.to("meta", torch.bfloat16) for t in (q, k, v)) + (
            bias.to("meta"),)
    with pytest.raises(ValueError):
        xa.cross_attention(*args)


@pytest.mark.parametrize("K,S,H,D,want", [
    (4, 49, 12, 64, (4, 64, 4, False)),   # the caption decode: one tile
    (4, 32, 12, 64, (4, 64, 4, False)),   # translation's short buckets
    (4, 128, 12, 64, (4, 64, 2, False)),  # two tiles
    (4, 2048, 12, 64, (2, 144, 2, False)),    # one block an SM
    (4, 20000, 12, 64, (4, 64, 4, True)),     # the scores in the scratch
    (5, 49, 6, 64, (3, 96, 4, False)),    # 6 heads a rank, beam 5
    (1, 49, 12, 128, (2, 64, 4, False)),
    (12, 49, 12, 64, (4, 64, 3, False)),  # two beam tiles
    (64, 7, 2, 64, (1, 272, 4, False)),   # 32 units of one head
])
def test_work_plan(K, S, H, D, want):
    plan = xa.work_plan(K, S, H, D)
    assert (plan.heads, plan.spos, plan.depth, plan.scratch) == want
    assert plan.smem <= xa.SMEM_LIMIT


def test_work_plan_refuses_too_many_beams():
    with pytest.raises(ValueError, match="no cross attention plan"):
        xa.work_plan(65, 7, 2, 64)


# ---------------- the decoder and the beam searches ----------------

V, B = 40, 3


def _randomise(model, seed):
    """Weights wide enough that the decodes depend on their inputs: every
    matrix, embedding and bias normal(0, 0.3), LayerNorm scales 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "LayerNorm.weight" in name:
                p.fill_(1.0)
            else:
                p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    return model.eval()


@contextlib.contextmanager
def per_beam_cross_attention():
    """The decoder before the deduplication: each layer's cache projects the
    encoder states repeated per beam, and the step's cross-attention is the
    plain attention on those rows under the bias repeated per beam."""
    init = tr.Decoder.init_cache
    op = tr.cross_attention

    def repeated_init(self, enc_states, batch, max_len):
        rows = enc_states.repeat_interleave(batch // enc_states.shape[0], 0)
        return init(self, rows, batch, max_len)

    def per_row(q, k, v, bias):
        reps = k.shape[0] // bias.shape[0]
        return plain_attention(q[:, None], k, v,
                               bias.repeat_interleave(reps, dim=0))[:, 0]

    tr.Decoder.init_cache, tr.cross_attention = repeated_init, per_row
    try:
        yield
    finally:
        tr.Decoder.init_cache, tr.cross_attention = init, op


def _states(S, E, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, E, generator=gen)
    keep = torch.arange(S)[None, :] < torch.tensor([S, S - 2, 1][:B])[:, None]
    return x, keep


def _same_both_ways(run):
    got = run()
    with per_beam_cross_attention():
        want = run()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got


@pytest.fixture(scope="module")
def text_model():
    return _randomise(Seq2Seq(tiny_config(vocab_size=V)), 0)


@pytest.mark.parametrize("K", [1, 4, 5])
def test_beam_search_tokens_equal_the_per_beam_path(text_model, K):
    enc, keep = _states(6, 32, seed=K)
    first = torch.full((B,), 6)
    langs = torch.ones(B, dtype=torch.long)
    best, lengths = _same_both_ways(lambda: beam_search(
        text_model, enc, keep, first, langs, keep.sum(1), beam_width=K,
        max_len=12, eos_id=4))
    assert best.shape == (B, 12)
    # The rows decode to other tokens: the source reaches the answer.
    assert len({tuple(r.tolist()) for r in best}) == B


@pytest.fixture(scope="module")
def image_model():
    cfg = tiny_config(vocab_size=V, img_size=64, use_obj=True)
    return _randomise(ImageSeq2Seq(cfg), 1)


@pytest.mark.parametrize("kind", ["text_grid", "grid_objects"])
def test_dual_beam_search_tokens_equal_the_per_beam_path(image_model, kind):
    a, a_keep = _states(7, 32, seed=11)
    b, b_keep = _states(5, 32, seed=12)
    first = torch.full((B,), 6)
    langs = torch.zeros(B, dtype=torch.long)
    kw = dict(beam_width=4, max_len=10, eos_id=4)
    if kind == "text_grid":
        run = lambda: beam_search_dual(   # noqa: E731
            image_model, a, a_keep, b, first, langs, **kw)
    else:
        run = lambda: beam_search_dual(   # noqa: E731
            image_model, a, torch.ones_like(a_keep), b, first, langs,
            grid_mask=b_keep, init_method=ImageSeq2Seq.init_obj_dual_cache,
            step_method=ImageSeq2Seq.decode_step_obj_dual, **kw)
    best, _ = _same_both_ways(run)
    assert len({tuple(r.tolist()) for r in best}) == B


def test_cache_keeps_the_encoder_kv_once_a_source(text_model):
    enc, keep = _states(6, 32, seed=2)
    seen = []
    init = text_model.init_cache

    def spy(states, batch, max_len, lang_idx=0):
        cache = init(states, batch, max_len, lang_idx)
        seen.append(cache)
        return cache

    text_model.init_cache = spy
    try:
        beam_search(text_model, enc, keep, torch.full((B,), 6),
                    torch.ones(B, dtype=torch.long), beam_width=4,
                    max_len=8)
    finally:
        del text_model.init_cache
    H, D = text_model.cfg.num_heads, text_model.cfg.head_dim
    for layer in seen[0]:
        assert layer["ek"].shape == layer["ev"].shape == (B, 6, H, D)
        assert layer["k"].shape == (B * 4, 8, H, D)
    with pytest.raises(ValueError, match="not beams"):
        text_model.init_cache(enc, 7, 8)


@pytest.mark.parametrize("dtype,op", [("bfloat16", "_launch"),
                                      ("float32",
                                       "cross_attention_reference")])
def test_decoder_step_routes_by_dtypes_off_the_cpu(monkeypatch, dtype, op):
    """On the ``meta`` device (routed as the card is): a bf16 model's step
    launches the kernel, an fp32 model's runs the plain version, once a
    layer, with the encoder K/V once a source."""
    cfg = tiny_config(dec_layers=2, dtype=dtype, kv_cache_dtype=dtype)
    dec = tr.Decoder(cfg, device="meta")
    calls = {"_launch": [], "cross_attention_reference": []}
    for name in calls:
        def recorder(q, k, v, bias, *_, _name=name):
            calls[_name].append((tuple(q.shape), tuple(k.shape), q.dtype,
                                 tuple(bias.shape)))
            return torch.empty_like(q)
        monkeypatch.setattr(xa, name, recorder)
    monkeypatch.setattr(tr, "decode_attention",
                        lambda q, k, v: torch.empty_like(q))
    enc = torch.empty(2, 5, cfg.hidden_size, dtype=cfg.compute_dtype,
                      device="meta")
    cache = dec.init_cache(enc, 8, 6)
    x = torch.empty(8, 1, cfg.hidden_size, dtype=cfg.compute_dtype,
                    device="meta")
    bias = torch.empty(2, 1, 1, 5, device="meta")
    assert dec.step(x, cache, 2, bias).shape == x.shape
    H, D = cfg.num_heads, cfg.head_dim
    assert calls[op] == [((8, H, D), (2, 5, H, D), cfg.compute_dtype,
                          (2, 1, 1, 5))] * 2
    assert not calls[({"_launch", "cross_attention_reference"}
                      - {op}).pop()]


# ---------------- on the card ----------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")


def _hold(B, K, S, H, D, seed):
    q, k, v, bias, _ = _inputs(B, K, S, H, D, seed, torch.bfloat16, "cuda")
    before = xa.LAUNCHES
    got = xa.cross_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert xa.LAUNCHES == before + 1
    want = xa.cross_attention_reference(q, k, v, bias)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    # Both round p to bf16: what is left is the order of the fp32 sums and
    # the output's rounding, two bf16 ulps of the largest value.
    tol = 2.0 ** -7 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,S,H,D", [
    (1536, 4, 49, 12, 64),     # the caption decode, R = 6144
    (1000, 4, 32, 12, 64),     # translation, R = 4000, padded tails
    (250, 4, 128, 12, 64),     # translation's long bucket, R = 1000
    (5, 1, 7, 12, 64), (7, 5, 49, 6, 64), (3, 4, 33, 4, 128),
    (3, 4, 17, 8, 32), (2, 12, 9, 12, 64), (3, 4, 11, 3, 8),
    (2, 3, 20, 5, 24), (4, 4, 1, 12, 64), (2, 4, 2048, 12, 64),
    (1, 4, 20000, 12, 64),
])
def test_kernel_matches_plain_version_on_the_card(B, K, S, H, D):
    _card()
    _hold(B, K, S, H, D, seed=B + K + S)


@pytest.mark.cuda
def test_kernel_is_deterministic_and_refuses_before_launching():
    _card()
    q, k, v, bias, _ = _inputs(64, 4, 49, 12, 64, 0, torch.bfloat16, "cuda")
    assert torch.equal(xa.cross_attention(q, k, v, bias),
                       xa.cross_attention(q, k, v, bias))
    before = xa.LAUNCHES
    # Dtypes other than bf16 q and K/V (an fp32 model) run the plain version.
    for plain in ((q.float(), k, v, bias), (q, k.float(), v.float(), bias)):
        assert torch.equal(xa.cross_attention(*plain),
                           xa.cross_attention_reference(*plain))
    for bad in ((q, k, v, bias.bfloat16()),
                (q, k.transpose(1, 2).contiguous().transpose(1, 2), v, bias),
                (q[:, :, :60].contiguous(), k[..., :60].contiguous(),
                 v[..., :60].contiguous(), bias)):
        with pytest.raises((ValueError, TypeError)):
            xa.cross_attention(*bad)
    assert xa.LAUNCHES == before


def _card_decoder():
    cfg = tiny_config(vocab_size=V, hidden_size=96, num_heads=12,
                      intermediate_size=128, dec_layers=3, dtype="bfloat16",
                      kv_cache_dtype="bfloat16", decode_attention_impl="fused")
    model = _randomise(Seq2Seq(cfg), 3).cuda()
    enc, keep = _states(9, 96, seed=5)
    return model, enc.cuda().bfloat16(), keep.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
def test_one_launch_a_layer_and_step_and_stream(K):
    """A bf16 decode launches the kernel once per decoder layer and step, and
    K4 as before, once per layer and step."""
    _card()
    from imagetranslate_tpu_torch.ops import decode_attention as da

    model, enc, keep = _card_decoder()
    steps = []
    step = model.decode_step

    def counted(*a, **kw):
        steps.append(1)
        return step(*a, **kw)

    model.decode_step = counted
    first = torch.full((B,), 6, device="cuda")
    langs = torch.ones(B, dtype=torch.long, device="cuda")
    x0, k0 = xa.LAUNCHES, da.LAUNCHES
    beam_search(model, enc, keep, first, langs, beam_width=K, max_len=10,
                eos_id=4)
    torch.cuda.synchronize()
    layers = model.cfg.dec_layers
    assert xa.LAUNCHES - x0 == layers * len(steps)
    assert da.LAUNCHES - k0 == layers * len(steps)


@pytest.mark.cuda
def test_dual_decode_launches_once_a_layer_and_step_a_stream():
    _card()
    cfg = tiny_config(vocab_size=V, hidden_size=96, num_heads=12,
                      intermediate_size=128, dec_layers=2, dtype="bfloat16",
                      kv_cache_dtype="bfloat16", img_size=64)
    model = _randomise(ImageSeq2Seq(cfg), 4).cuda()
    a, a_keep = _states(7, 96, seed=11)
    g, _ = _states(5, 96, seed=12)
    steps = []
    step = type(model).decode_step_dual

    def counted(self, *a, **kw):
        steps.append(1)
        return step(self, *a, **kw)

    x0 = xa.LAUNCHES
    beam_search_dual(model, a.cuda().bfloat16(), a_keep.cuda(),
                     g.cuda().bfloat16(), torch.full((B,), 6, device="cuda"),
                     torch.zeros(B, dtype=torch.long, device="cuda"),
                     beam_width=4, max_len=8, eos_id=4, step_method=counted)
    torch.cuda.synchronize()
    assert xa.LAUNCHES - x0 == 2 * cfg.dec_layers * len(steps)


@pytest.mark.cuda
def test_trace_name_is_read_by_k6_alone():
    """The kernel's name in the device trace matches the benchmark's
    ``kernels/k6.py`` and no other kernel file (K4's roofline reads K4
    alone)."""
    _card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q, k, v, bias, _ = _inputs(8, 4, 49, 12, 64, 0, torch.bfloat16, "cuda")
    xa.cross_attention(q, k, v, bias)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        xa.cross_attention(q, k, v, bias)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA}
    ours = [n for n in names if "cross_attn" in n]
    assert ours, names
    for path in glob.glob(os.path.join(ROOT, "benchmark", "kernels",
                                       "*.py")):
        text = open(path).read()
        pattern = re.search(r'TRACE_NAMES = r"(.*)"', text).group(1)
        hit = any(re.search(pattern, n) for n in ours)
        assert hit == path.endswith("k6.py"), (path, ours)
