"""The port's MASS and MLM masking against the JAX package's.

The two packages cannot share random bits (``jax.random`` against a
``torch.Generator``), so the comparison is in two parts:

- the deterministic cores (``mass_mask_core``, ``mask_text_core``) are fed
  the very draws the JAX functions make (the ``jax.random.split`` /
  ``uniform`` / ``randint`` calls of imagetranslate_tpu/ops/masking.py,
  repeated here) and must equal ``mass_mask`` / ``mask_text`` element for
  element;
- the port's own generator (``draw_mass``, ``draw_mlm``) passes the
  invariants and the distribution checks of tests/test_masking_and_lm.py:
  contiguous spans of L // 2 inside the row, the 20/20/60 start rule,
  80/10/10 corruption.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.ops import masking as jmasking
from imagetranslate_tpu_torch.ops import masking

V, NSPEC, MASK_ID, PAD, EOS = 64, 5, 3, 0, 4
KW = dict(mask_id=MASK_ID, pad_id=PAD)


def make_src(B=8, S=16, seed=0, short=False):
    rng = np.random.RandomState(seed)
    src = rng.randint(NSPEC, V, (B, S)).astype(np.int32)
    if short:
        lengths = rng.randint(1, S + 1, B).astype(np.int32)
    else:
        lengths = np.array([S - (i % 4) for i in range(B)], np.int32)
    src = np.where(np.arange(S)[None, :] < lengths[:, None], src, PAD)
    return src.astype(np.int32), lengths


def jax_mass_draws(rng, src, lengths, mask_prob):
    """The draws of ``jax mass_mask(rng, ...)``, as torch tensors."""
    B = src.shape[0]
    r_kind, r_start, r_corrupt = jax.random.split(rng, 3)
    lengths = jnp.asarray(lengths).astype(jnp.int32)
    last_idx = jnp.maximum(jnp.ceil(lengths.astype(jnp.float32)
                                    * mask_prob).astype(jnp.int32), 2)
    kind = jax.random.uniform(r_kind, (B,))
    rand_start = jax.random.randint(r_start, (B,), 2, last_idx + 1)
    r_choice, r_rand = jax.random.split(r_corrupt)
    u = jax.random.uniform(r_choice, src.shape)
    rand_tok = jax.random.randint(r_rand, src.shape, NSPEC, V)
    return masking.MassDraws(*(torch.tensor(np.asarray(a))
                               for a in (kind, rand_start, u, rand_tok)))


@pytest.mark.parametrize("B,S,seed,mask_prob,short", [
    (8, 16, 0, 0.5, False), (64, 16, 1, 0.5, True), (64, 33, 2, 0.3, True),
    (32, 12, 3, 0.9, True),
])
def test_mass_core_equals_jax_under_shared_draws(B, S, seed, mask_prob,
                                                 short):
    src, lengths = make_src(B, S, seed, short)
    rng = jax.random.PRNGKey(seed + 10)
    W = S // 2 + 1
    want = jmasking.mass_mask(rng, jnp.asarray(src), jnp.asarray(lengths),
                              mask_prob, n_specials=NSPEC, vocab_size=V,
                              span_width=W, **KW)
    got = masking.mass_mask_core(
        jax_mass_draws(rng, src, lengths, mask_prob), torch.tensor(src),
        torch.tensor(lengths), mask_prob, span_width=W, **KW)
    for name in ("src", "dec_inputs", "positions", "span_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.dec_inputs.shape == got.positions.shape == (B, W)


@pytest.mark.parametrize("mask_eos", [True, False])
def test_mlm_core_equals_jax_under_shared_draws(mask_eos):
    src, lengths = make_src(16, 20, 4, short=True)
    src[:, 3] = np.where(src[:, 3] != PAD, EOS, PAD)
    rng = jax.random.PRNGKey(7)
    want = jmasking.mask_text(rng, jnp.asarray(src), jnp.asarray(src != PAD),
                              0.4, mask_id=MASK_ID, eos_id=EOS,
                              n_specials=NSPEC, vocab_size=V,
                              mask_eos=mask_eos)
    r_sel, r_corrupt = jax.random.split(rng)
    r_choice, r_rand = jax.random.split(r_corrupt)
    draws = masking.MLMDraws(*(torch.tensor(np.asarray(a)) for a in (
        jax.random.uniform(r_sel, src.shape),
        jax.random.uniform(r_choice, src.shape),
        jax.random.randint(r_rand, src.shape, NSPEC, V))))
    got = masking.mask_text_core(draws, torch.tensor(src),
                                 torch.tensor(src != PAD), 0.4,
                                 mask_id=MASK_ID, eos_id=EOS,
                                 mask_eos=mask_eos)
    np.testing.assert_array_equal(got.texts.numpy(), np.asarray(want.texts))
    np.testing.assert_array_equal(got.target_mask.numpy(),
                                  np.asarray(want.target_mask))
    if not mask_eos:
        assert not got.target_mask[:, 3].any()


def _port_mass(src, lengths, seed, mask_prob=0.5):
    S = src.shape[1]
    return masking.mass_mask(
        torch.Generator().manual_seed(seed), torch.tensor(src),
        torch.tensor(lengths), mask_prob, n_specials=NSPEC, vocab_size=V,
        span_width=S // 2 + 1, **KW)


@pytest.mark.parametrize("short", [False, True])
def test_mass_mask_invariants(short):
    src, lengths = make_src(B=64, S=16, seed=0, short=short)
    out = _port_mass(src, lengths, 1)
    span = out.span_mask.numpy()
    dec, positions = out.dec_inputs.numpy(), out.positions.numpy()
    for b in range(src.shape[0]):
        idx = np.where(span[b])[0]
        if lengths[b] < 2:                 # nothing to mask in a 1-token row
            assert len(idx) == 0
            continue
        assert len(idx) > 0
        assert (np.diff(idx) == 1).all()               # contiguous
        assert len(idx) <= lengths[b] // 2             # L // 2, or clamped
        assert idx[0] >= 1 and idx[-1] < lengths[b]    # not position 0, no pad
        # dec_inputs: the (uncorrupted) token before the span, then the span
        assert dec[b, 0] == src[b, idx[0] - 1]
        assert (dec[b, 1:1 + len(idx)] == src[b, idx]).all()
        assert (dec[b, 1 + len(idx):] == PAD).all()
        assert (positions[b, :1 + len(idx)]
                == np.arange(idx[0] - 1, idx[-1] + 1)).all()
        assert (positions[b, 1 + len(idx):] == src.shape[1] - 1).all()
    corrupted = out.src.numpy()
    assert (corrupted[~span] == src[~span]).all()      # only inside the span
    assert ((corrupted != src) & span).sum() > 0
    # same seed, same masks; another seed, other masks
    again = _port_mass(src, lengths, 1)
    assert torch.equal(again.src, out.src)
    assert not torch.equal(_port_mass(src, lengths, 2).span_mask,
                           out.span_mask)


def test_mass_mask_distribution():
    """20/20/60 start rule and 80/10/10 corruption, statistically."""
    src, lengths = make_src(B=3000, S=16, seed=2)
    out = _port_mass(src, lengths, 3)
    starts = out.positions.numpy()[:, 0] + 1
    last_idx = np.maximum(np.ceil(lengths * 0.5), 2).astype(int)
    assert 0.17 < (starts == 1).mean() < 0.23
    # 20 % at last_idx, plus the share of the uniform 60 % that lands there
    at_last = (starts == last_idx).mean()
    assert 0.2 + 0.6 / 8 - 0.04 < at_last < 0.2 + 0.6 / 6 + 0.04
    assert ((starts >= 1) & (starts <= last_idx)).all()
    for s in range(2, 7):                  # the uniform branch reaches all
        assert (starts == s).mean() > 0.05
    span = out.span_mask.numpy()
    corrupted = out.src.numpy()
    assert 0.77 < (corrupted[span] == MASK_ID).mean() < 0.83
    same = (corrupted[span] == src[span]).mean()       # 10 % + chance hits
    assert 0.08 < same < 0.14
    rand = corrupted[span][(corrupted[span] != MASK_ID)
                           & (corrupted[span] != src[span])]
    assert rand.min() >= NSPEC and rand.max() < V


def test_mlm_mask():
    src, _ = make_src(B=200, S=16, seed=5)
    pads = src != PAD
    out = masking.mask_text(torch.Generator().manual_seed(4),
                            torch.tensor(src), torch.tensor(pads), 0.5,
                            mask_id=MASK_ID, eos_id=EOS, n_specials=NSPEC,
                            vocab_size=V)
    sel = out.target_mask.numpy()
    assert not (sel & ~pads).any()                     # never masks pads
    assert 0.45 < sel[pads].mean() < 0.55
    texts = out.texts.numpy()
    assert (texts[~sel] == src[~sel]).all()
    assert 0.75 < (texts[sel] == MASK_ID).mean() < 0.85
