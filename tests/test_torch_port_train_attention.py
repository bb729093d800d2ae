"""The port's fused dropout attention (ops/train_attention.py) against the
JAX package, on the CPU.

At rate 0 the plain version must give what the JAX ``fused_dropout_attention``
gives in Pallas interpret mode (as tests/test_train_attention.py runs it) and
what ``_xla_attention`` gives: forward atol/rtol 1e-5, dq/dk/dv/dbias 2e-4
(the JAX test's own tolerances; fp32 sums in another order), both bias
layouts, inputs from a numpy seed. At rate > 0 the masks of the two packages
differ bit for bit by design, so the contract is the distribution: keep
rate, unbiased mean over seeds, the same mask per seed, and autograd through
the plain version equal to the hand-derived backward formulas under the same
mask (atol 1e-5). At T = S = 512, the range the kernels newly admit, the
plain version equals the Pallas kernel at rate 0 too. The keep bits the
forward kernel saves for the backward are held to ``keep_mask`` through the
plain packing, and the backward kernels' one-pass formulas (saved bits,
delta = rowsum(g * out)) to the exact backward and, at rate 0, to the JAX
kernel. A bf16 LM in training
at T = 512 routes its attention to the fused op (on the ``meta`` device,
routed as the card is). The Philox generator is held bit-exactly to the
published known-answer vectors. The CUDA kernels themselves are compared with
the plain version in the ``cuda``-marked test, which skips without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.ops.attention import _xla_attention
from imagetranslate_tpu.ops.train_attention import (
    _keep_threshold as jax_keep_threshold,
)
from imagetranslate_tpu.ops.train_attention import (
    fused_dropout_attention as jax_fused,
)
from imagetranslate_tpu_torch.models import transformer as tr
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.models.lm import LM
from imagetranslate_tpu_torch.ops import attention as attention_mod
from imagetranslate_tpu_torch.ops import train_attention as ta
from imagetranslate_tpu_torch.ops.attention import dot_product_attention

B, T, S, H, D = 2, 16, 24, 3, 8


def _inputs(layout, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, S, H, D).astype(np.float32)
    v = rng.randn(B, S, H, D).astype(np.float32)
    g = rng.randn(B, T, H, D).astype(np.float32)
    rows = T if layout == "rows" else 1
    bias = rng.randn(B, 1, rows, S).astype(np.float32)
    bias[1, :, :, -5:] = -10000.0                      # masked keys
    if layout == "rows":
        bias[0, 0, 3, :] = -10000.0                    # a fully masked query
    return q, k, v, bias, g


def _torch_grads(fn, arrays, g):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    return out, torch.autograd.grad(out, ts, torch.tensor(g))


@pytest.mark.parametrize("layout", ["keys", "rows"])
def test_rate0_forward_matches_jax(layout):
    q, k, v, bias, _ = _inputs(layout)
    got = ta.fused_dropout_attention(*map(torch.tensor, (q, k, v, bias)),
                                     0.0, 7)
    kern = jax_fused(q, k, v, bias, 0.0, jnp.int32(7))    # interpret mode
    ref = _xla_attention(*map(jnp.asarray, (q, k, v, bias)))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), 1e-5, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), 1e-5, 1e-5)


@pytest.mark.parametrize("layout", ["keys", "rows"])
def test_rate0_grads_match_jax(layout):
    q, k, v, bias, g = _inputs(layout)
    _, got = _torch_grads(
        lambda *a: ta.fused_dropout_attention(*a, 0.0, 7), (q, k, v, bias), g)
    hand = ta.fused_dropout_attention_backward_reference(
        *map(torch.tensor, (q, k, v, bias, g)), 0.0, 7)

    def vjp(fn):
        _, pull = jax.vjp(fn, *map(jnp.asarray, (q, k, v, bias)))
        return pull(jnp.asarray(g))

    kern = vjp(lambda *a: jax_fused(*a, 0.0, jnp.int32(7)))
    ref = vjp(_xla_attention)
    assert float(np.abs(np.asarray(ref[3])).max()) > 0
    for name, a, h_, b_, c_ in zip("q k v bias".split(), got, hand, kern,
                                   ref):
        assert a.shape == np.shape(b_), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), 2e-4, 2e-4,
                                   err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(c_), 2e-4, 2e-4,
                                   err_msg=name)
        np.testing.assert_allclose(h_.numpy(), np.asarray(b_), 2e-4, 2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0), "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox_known_answers(counter, key, want):
    """The known-answer vectors of the Random123 distribution for
    philox4x32-10."""
    got = ta.philox4x32_10(counter, key)
    assert " ".join(f"{int(x):08x}" for x in got) == want


def test_philox_bits_are_a_function_of_the_coordinates():
    """Element (b, h, t, s) draws word s % 4 of the block at counter
    (s // 4, t, h, b), whatever the tensor's extent."""
    seed = (5 << 32) | 1234
    bits = ta.philox_bits(seed, 3, 2, 5, 11)
    assert bits.shape == (3, 2, 5, 11)
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    for b, h, t, s in ((0, 0, 0, 0), (2, 1, 4, 10), (1, 0, 3, 6)):
        words = ta.philox4x32_10((s // 4, t, h, b), (1234, 5))
        assert int(bits[b, h, t, s]) == int(words[s % 4])
    bigger = ta.philox_bits(seed, 4, 3, 7, 16)
    assert torch.equal(bigger[:3, :2, :5, :11], bits)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 0.999999])
def test_keep_threshold_is_the_jax_rule(rate):
    assert ta._keep_threshold(rate) == jax_keep_threshold(rate)


def test_keep_rate_and_seed_determinism():
    rate, n = 0.1, 4 * 6 * 32 * 64
    a = ta.keep_mask(rate, 11, 4, 6, 32, 64)
    assert torch.equal(a, ta.keep_mask(rate, 11, 4, 6, 32, 64))
    other = ta.keep_mask(rate, 12, 4, 6, 32, 64)
    assert 0.1 < (a != other).float().mean() < 0.26       # ~2 * 0.1 * 0.9
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(a.float().mean().item() - (1 - rate)) < 4 * sigma


def test_dropout_is_unbiased_over_seeds():
    q, k, v, bias, _ = _inputs("keys")
    args = tuple(map(torch.tensor, (q, k, v, bias)))
    clean = ta.fused_dropout_attention(*args, 0.0, 0)
    n = 300
    mean = sum(ta.fused_dropout_attention(*args, 0.3, s)
               for s in range(n)) / n
    # The mean of n draws strays by ~|v| * sqrt(rate / ((1 - rate) n S)).
    assert (mean - clean).abs().mean() < 0.03
    assert (mean - clean).abs().max() < 0.25
    one = ta.fused_dropout_attention(*args, 0.3, 5)
    assert torch.equal(one, ta.fused_dropout_attention(*args, 0.3, 5))
    assert not torch.equal(one, ta.fused_dropout_attention(*args, 0.3, 6))


@pytest.mark.parametrize("layout", ["keys", "rows"])
def test_autograd_equals_hand_backward_under_the_same_mask(layout):
    q, k, v, bias, g = _inputs(layout, seed=3)
    rate, seed = 0.25, 99
    out, got = _torch_grads(
        lambda *a: ta.fused_dropout_attention(*a, rate, seed),
        (q, k, v, bias), g)
    hand = ta.fused_dropout_attention_backward_reference(
        *map(torch.tensor, (q, k, v, bias, g)), rate, seed)
    for name, a, b_ in zip("q k v bias".split(), got, hand):
        assert a.shape == b_.shape, name
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    # out is linear in v for a fixed mask: the same mask ran in both passes.
    v2 = torch.tensor(v) + 0.5
    out2 = ta.fused_dropout_attention(torch.tensor(q), torch.tensor(k), v2,
                                      torch.tensor(bias), rate, seed)
    lin = (torch.tensor(g) * (out2 - out.detach())).sum()
    np.testing.assert_allclose(lin.item(), (got[2] * 0.5).sum().item(),
                               rtol=1e-4)


@pytest.mark.parametrize("S", [33, 64, 255, 257])
def test_packed_keep_bits_equal_keep_mask(S):
    """The words the forward kernel saves for the backward: bit i of word w
    of a row is key 32 w + i of keep_mask, keys past S and the padding words
    zero, a row padded to a multiple of four words (16 bytes)."""
    b, h, t = 2, 3, 5
    keep = ta.keep_mask(0.3, 77, b, h, t, S)
    words = ta.pack_keep_bits(keep)
    W = ta.keep_words(S)
    assert W % 4 == 0 and 32 * (W - 4) < S <= 32 * W
    assert words.shape == (b, h, t, W) and words.dtype == torch.int32
    assert torch.equal(ta.unpack_keep_bits(words, S), keep)
    u = words.to(torch.int64) & 0xFFFFFFFF
    for bi, hi, ti, s in ((0, 0, 0, 0), (1, 2, 4, S - 1), (1, 1, 2, S // 2)):
        assert (int(u[bi, hi, ti, s // 32]) >> (s % 32)) & 1 == int(
            keep[bi, hi, ti, s])
    tail = ta.unpack_keep_bits(words, 32 * W)[..., S:]
    assert not tail.any()


def _bf16_out(q, k, v, bias, rate, seed):
    """The forward's output rounded to bf16, as the kernel saves it."""
    out = ta.fused_dropout_attention_reference(
        *map(torch.tensor, (q, k, v, bias)), rate, seed)
    return out.to(torch.bfloat16).to(torch.float32)


@pytest.mark.parametrize("layout", ["keys", "rows"])
def test_saved_bits_backward_agrees_with_exact(layout):
    """The backward kernels' one-pass formulas (the mask from the saved
    words, delta = rowsum(g * out) over the bf16 output) against the exact
    backward (delta = rowsum(p * dp) in fp32) under the same mask: within
    2^-6 of the largest value of dq, dk and dv, the kernels' own tolerance
    on the card (ATTN_TOL): delta moves by ~2^-9 of |g| |out| through out's
    bf16 rounding, and p times that stays a few bf16 ulps of the result."""
    q, k, v, bias, g = _inputs(layout, seed=5)
    rate, seed = 0.1, 21
    words = ta.pack_keep_bits(ta.keep_mask(rate, seed, B, H, T, S))
    tq, tk, tv, tb, tg = map(torch.tensor, (q, k, v, bias, g))
    got = ta.fused_dropout_attention_backward_saved(
        tq, tk, tv, tb, tg, _bf16_out(q, k, v, bias, rate, seed), words,
        rate)
    want = ta.fused_dropout_attention_backward_reference(
        tq, tk, tv, tb, tg, rate, seed)[:3]
    for name, a, b_ in zip("q k v".split(), got, want):
        assert a.shape == b_.shape, name
        scale = b_.abs().max().item()
        assert scale > 0, name
        assert (a - b_).abs().max().item() <= 2.0 ** -6 * scale, name


@pytest.mark.parametrize("rate", [2.0 ** -34, 2.0 ** -32])
def test_saved_bits_follow_the_threshold(rate):
    """Whether the kernels draw a mask (and so save and read keep bits) is
    decided by the rounded threshold, not by rate > 0: below 2^-33 the
    threshold is 0 and keep_mask keeps every key, the forward saves no
    words, and the one-pass backward with no words still scales by
    1 / (1 - rate) and equals the exact backward."""
    assert ta.draws_mask(rate) == (ta._keep_threshold(rate) > 0)
    assert not ta.draws_mask(0.0)
    keep = ta.keep_mask(rate, 3, B, H, T, S)
    if not ta.draws_mask(rate):
        assert keep.all()
        q, k, v, bias, g = map(torch.tensor, _inputs("keys", seed=8))
        out = ta.fused_dropout_attention_reference(q, k, v, bias, rate, 3)
        got = ta.fused_dropout_attention_backward_saved(q, k, v, bias, g,
                                                        out, None, rate)
        want = ta.fused_dropout_attention_backward_reference(
            q, k, v, bias, g, rate, 3)[:3]
        for name, a, b_ in zip("q k v".split(), got, want):
            np.testing.assert_allclose(a.numpy(), b_.numpy(), 1e-5, 1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("layout", ["keys", "rows"])
def test_saved_bits_backward_rate0_matches_jax(layout):
    """At rate 0 (no words) the one-pass backward over the fp32 output equals
    the JAX kernel's ``_bwd_rule`` in Pallas interpret mode (through
    ``jax.vjp``, as tests/test_train_attention.py runs it), as does the exact
    plain backward: 2e-4, the JAX test's own tolerance."""
    q, k, v, bias, g = _inputs(layout, seed=6)
    tq, tk, tv, tb, tg = map(torch.tensor, (q, k, v, bias, g))
    out = ta.fused_dropout_attention_reference(tq, tk, tv, tb, 0.0, 0)
    got = ta.fused_dropout_attention_backward_saved(tq, tk, tv, tb, tg, out,
                                                    None, 0.0)
    exact = ta.fused_dropout_attention_backward_reference(tq, tk, tv, tb, tg,
                                                          0.0, 0)[:3]
    _, pull = jax.vjp(lambda *a: jax_fused(*a, 0.0, jnp.int32(7)),
                      *map(jnp.asarray, (q, k, v, bias)))
    want = pull(jnp.asarray(g))[:3]
    for name, a, e, w in zip("q k v".split(), got, exact, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), 2e-4, 2e-4,
                                   err_msg=name)
        np.testing.assert_allclose(e.numpy(), np.asarray(w), 2e-4, 2e-4,
                                   err_msg=name)


def test_dispatch_order_and_gate():
    """dot_product_attention: dropout off -> plain path, no seed needed;
    dropout on with use_fused_dropout -> the fused op (same mask as calling
    it directly); without -> the plain path's own mask. The CUDA gate takes
    bf16 at the flagship and packed shapes and refuses what the kernels do
    not take."""
    q, k, v, bias, _ = _inputs("keys")
    tq, tk, tv, tb = map(torch.tensor, (q, k, v, bias))
    clean = dot_product_attention(tq, tk, tv, tb)
    same = dot_product_attention(tq, tk, tv, tb, dropout_rate=0.3,
                                 deterministic=True, use_fused_dropout=True)
    assert torch.equal(clean, same)
    fused = dot_product_attention(tq, tk, tv, tb, dropout_rate=0.3,
                                  deterministic=False, seed=5,
                                  use_fused_dropout=True)
    assert torch.equal(fused,
                       ta.fused_dropout_attention(tq, tk, tv, tb, 0.3, 5))
    no_bias = dot_product_attention(tq, tk, tv, None, dropout_rate=0.3,
                                    deterministic=False, seed=5,
                                    use_fused_dropout=True)
    assert torch.equal(no_bias, ta.fused_dropout_attention(
        tq, tk, tv, torch.zeros(B, 1, 1, S), 0.3, 5))
    plain = dot_product_attention(tq, tk, tv, tb, dropout_rate=0.3,
                                  deterministic=False, seed=5)
    assert plain.shape == clean.shape and not torch.equal(plain, fused)
    assert torch.equal(plain, dot_product_attention(
        tq, tk, tv, tb, dropout_rate=0.3, deterministic=False, seed=5))
    with pytest.raises(ValueError, match="seed"):
        dot_product_attention(tq, tk, tv, tb, dropout_rate=0.3,
                              deterministic=False)

    def ok(shape_q, shape_k, bias_shape=None, dtype=torch.bfloat16):
        bias_ = None if bias_shape is None else torch.zeros(bias_shape)
        return ta.fused_attention_supported(
            torch.zeros(shape_q, dtype=dtype), torch.zeros(shape_k,
                                                           dtype=dtype),
            bias_)

    assert ok((256, 64, 12, 64), (256, 64, 12, 64), (256, 1, 1, 64))
    assert ok((32, 256, 12, 64), (32, 256, 12, 64), (32, 1, 256, 256))
    assert ok((2, 7, 3, 16), (2, 33, 3, 16))                # ragged, no bias
    assert not ok((2, 8, 3, 64), (2, 8, 3, 64), dtype=torch.float32)
    # Shared memory: keys stream through the kernels in tiles, so S runs to
    # the JAX gate's cap of 512 in both bias layouts (the MLM step's 512).
    for n in (272, 512):
        assert ok((2, 8, 3, 64), (2, n, 3, 64), (2, 1, 1, n))
        assert ok((2, 8, 3, 64), (2, n, 3, 64), (2, 1, 8, n))
    assert not ok((2, 8, 3, 64), (2, 513, 3, 64))           # past the cap
    assert not ok((2, 8, 3, 8), (2, 8, 3, 8))               # D
    assert not ok((2, 8, 3, 48), (2, 8, 3, 48))             # D
    assert not ok((2, 8, 3, 64), (2, 8, 3, 64), (2, 3, 1, 8))   # head axis
    assert not ok((2, 8, 3, 64), (2, 8, 3, 64), (2, 1, 4, 8))   # rows != T


def test_refuses_other_devices_and_rates():
    q = torch.zeros((1, 4, 1, 16), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ta.fused_dropout_attention(q, q, q, torch.zeros((1, 1, 1, 4),
                                                        device="meta"), 0.1, 0)
    c = torch.zeros((1, 4, 1, 16))
    with pytest.raises(ValueError, match="rate"):
        ta.fused_dropout_attention(c, c, c, torch.zeros(1, 1, 1, 4), 1.0, 0)


def test_rate0_long_keys_match_jax():
    """The range the redesigned kernels newly admit: at T = S = 512 the
    plain forward and its gradients equal the JAX kernel's in Pallas
    interpret mode (one jitted program for the output and the vjp), inputs
    from a numpy seed, a padding bias with masked keys; forward atol/rtol
    1e-5, gradients 2e-4, as at S = 24."""
    rng = np.random.RandomState(4)
    b, n, h, d = 1, 512, 1, 16
    q, k, v, g = (rng.randn(b, n, h, d).astype(np.float32) for _ in range(4))
    bias = rng.randn(b, 1, 1, n).astype(np.float32)
    bias[..., -37:] = -10000.0

    @jax.jit
    def kernel(q, k, v, bias, g):
        out, pull = jax.vjp(lambda *a: jax_fused(*a, 0.0, jnp.int32(7)),
                            q, k, v, bias)
        return out, pull(g)

    want_out, want = kernel(*map(jnp.asarray, (q, k, v, bias, g)))
    out, got = _torch_grads(
        lambda *a: ta.fused_dropout_attention(*a, 0.0, 7), (q, k, v, bias), g)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               1e-5, 1e-5)
    assert float(np.abs(np.asarray(want[3])).max()) > 0
    for name, a, b_ in zip("q k v bias".split(), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), 2e-4, 2e-4,
                                   err_msg=name)


class _MetaDropout(tr.DropoutRng):
    """A dropout stream without generators (the meta device has none):
    attention seeds count up, elementwise dropout is the identity."""

    def __init__(self):
        self.seeds = iter(range(1, 1 << 20))

    def next_seed(self) -> int:
        return next(self.seeds)

    def dropout(self, x, rate):
        return x


@pytest.mark.parametrize("dtype,want", [("bfloat16", "fused"),
                                        ("float32", "plain")])
def test_lm_training_at_512_routes_to_the_kernels(monkeypatch, dtype, want):
    """The MLM step's attention off the CPU (the meta device, routed as the
    card is): a bf16 LM in training at T = 512 with dropout on reaches
    fused_dropout_attention in every layer, with the [B, 1, 1, S] padding
    bias; an fp32 LM, outside the kernels' gate, takes the plain attention."""
    calls = []

    def record(name):
        def fn(q, k, v, bias, *rest):
            calls.append((name, tuple(q.shape), tuple(k.shape),
                          tuple(bias.shape)))
            return torch.empty_like(v)
        return fn

    monkeypatch.setattr(ta, "fused_dropout_attention", record("fused"))
    monkeypatch.setattr(attention_mod, "plain_attention", record("plain"))
    cfg = tiny_config(hidden_size=128, num_heads=2, max_position_embeddings=512,
                      enc_layers=2, dropout=0.1, attention_dropout=0.1,
                      dtype=dtype)
    model = LM(cfg, device="meta")
    B, T = 2, 512
    texts = torch.zeros((B, T), dtype=torch.long, device="meta")
    mask = torch.ones((B, T), dtype=torch.bool, device="meta")
    langs = torch.zeros((B,), dtype=torch.long, device="meta")
    hidden = model.encode(texts, mask, langs, deterministic=False,
                          rng=_MetaDropout())
    assert hidden.shape == (B, T, cfg.hidden_size)
    assert calls == [(want, (B, T, 2, 64), (B, T, 2, 64), (B, 1, 1, T))] * 2


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """The CUDA forward and backward kernels against the plain version on the
    card, element by element under the shared Philox mask: the train step's
    three shapes (encoder, decoder self- and cross-attention), packed,
    cross-attention (T != S), ragged shapes and the MLM step's (T = S = 512),
    both bias layouts, rate 0 and 0.1; then the caption step's
    cross-attention over the 49-slot grid (a zero bias) and over 16
    detections (a keep-mask with an all-padding row). Tolerance: 2^-6 of
    the plain result's largest magnitude (a few bf16 ulps) for the bf16
    outputs, 1e-4 of it for the fp32 dbias."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    fwd, bwd = ta.FWD_LAUNCHES, ta.BWD_LAUNCHES
    cases = [(256, 64, 64, 12, 64), (256, 63, 63, 12, 64),
             (256, 63, 64, 12, 64), (32, 256, 256, 12, 64),
             (8, 40, 72, 3, 64), (3, 100, 33, 2, 32), (2, 130, 16, 1, 128),
             (16, 512, 512, 12, 64), (2, 7, 511, 2, 64)]
    n = 0
    for b, t, s, h, d in cases:
        for rows in (1, t):
            for rate in (0.0, 0.1):
                q, k, v, g = (
                    torch.randn(b, n_, h, d, generator=gen,
                                device="cuda").bfloat16()
                    for n_ in (t, s, s, t))
                bias = torch.randn(b, 1, rows, s, generator=gen,
                                   device="cuda")
                bias[:, :, :, -3:] = -10000.0
                leaves = [x.clone().requires_grad_(True)
                          for x in (q, k, v, bias)]
                out = ta.fused_dropout_attention(*leaves, rate, 5)
                grads = torch.autograd.grad(out, leaves, g)
                torch.cuda.synchronize()
                n += 1
                want = ta.fused_dropout_attention_reference(q, k, v, bias,
                                                            rate, 5)
                hand = ta.fused_dropout_attention_backward_reference(
                    q, k, v, bias, g, rate, 5)
                for got, ref, tol in zip(
                        (out, *grads), (want, *hand),
                        (2 ** -6,) * 4 + (1e-4,)):
                    err = (got.float() - ref.float()).abs().max()
                    assert err <= tol * ref.float().abs().max(), (b, t, s, h,
                                                                  d, rows,
                                                                  rate)
    # The caption step's shapes with the biases it builds: cross-attention
    # over the 49-slot grid under a zero bias, and over 16 detections under
    # the keep-mask's bias with a row whose detections are all padding (its
    # softmax is uniform over -10000s, as in the plain version).
    keep = torch.ones(32, 16, dtype=torch.bool, device="cuda")
    keep[:, 10:] = False
    keep[3] = False
    for s, bias in ((49, torch.zeros(32, 1, 1, 49, device="cuda")),
                    (16, (1.0 - keep.float())[:, None, None, :] * -10000.0)):
        for rate in (0.0, 0.1):
            q, g = (torch.randn(32, 31, 12, 64, generator=gen,
                                device="cuda").bfloat16() for _ in range(2))
            k, v = (torch.randn(32, s, 12, 64, generator=gen,
                                device="cuda").bfloat16() for _ in range(2))
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out = ta.fused_dropout_attention(*leaves, bias, rate, 7)
            grads = torch.autograd.grad(out, leaves, g)
            torch.cuda.synchronize()
            n += 1
            want = ta.fused_dropout_attention_reference(q, k, v, bias, rate,
                                                        7)
            hand = ta.fused_dropout_attention_backward_reference(
                q, k, v, bias, g, rate, 7)[:3]
            for got, ref in zip((out, *grads), (want, *hand)):
                assert torch.isfinite(got).all(), (s, rate)
                err = (got.float() - ref.float()).abs().max()
                assert err <= 2 ** -6 * ref.float().abs().max(), (s, rate)
    assert ta.FWD_LAUNCHES == fwd + n and ta.BWD_LAUNCHES == bwd + n
