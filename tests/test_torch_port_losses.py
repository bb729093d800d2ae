"""The port's label-smoothed loss (ops/losses.py) against the JAX package:
the same logits, targets and masks from a numpy seed through both, fp32.
Sum and count within rtol 1e-5 (fp32 sums in another order); the gradient of
sum/count with respect to the logits within atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.ops import losses as jlosses
from imagetranslate_tpu_torch.ops import losses


def _inputs(seed, shape=(3, 7), vocab=50):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape, vocab) * 3).astype(np.float32)
    targets = rng.randint(0, vocab, shape).astype(np.int32)
    mask = rng.rand(*shape) > 0.3
    mask[1] = False                                   # a fully masked row
    return logits, targets, mask


@pytest.mark.parametrize("epsilon", [0.1, 0.0, 0.3])
@pytest.mark.parametrize("seed", [0, 1])
def test_smoothed_nll_matches_jax(epsilon, seed):
    logits, targets, mask = _inputs(seed)
    want_sum, want_n = jlosses.smoothed_nll_loss(logits, targets, mask,
                                                 epsilon)
    got_sum, got_n = losses.smoothed_nll_loss(
        torch.tensor(logits), torch.tensor(targets), torch.tensor(mask),
        epsilon)
    assert got_sum.dtype == torch.float32 and got_sum.shape == ()
    np.testing.assert_allclose(got_sum.item(), float(want_sum), rtol=1e-5)
    assert got_n.item() == float(want_n) == mask.sum()


def test_nll_is_epsilon_zero_and_masks_count():
    logits, targets, mask = _inputs(2)
    t = (torch.tensor(logits), torch.tensor(targets), torch.tensor(mask))
    want_sum, want_n = jlosses.nll_loss(logits, targets, mask)
    got_sum, got_n = losses.nll_loss(*t)
    np.testing.assert_allclose(got_sum.item(), float(want_sum), rtol=1e-5)
    assert torch.equal(got_sum, losses.smoothed_nll_loss(*t, epsilon=0.0)[0])
    # float masks weigh, an all-false mask gives (0, 0)
    fsum, fn = losses.smoothed_nll_loss(t[0], t[1], t[2].float() * 0.5)
    np.testing.assert_allclose(fsum.item(),
                               0.5 * losses.smoothed_nll_loss(*t)[0].item(),
                               rtol=1e-6)
    assert fn.item() == 0.5 * got_n.item()
    zsum, zn = losses.smoothed_nll_loss(t[0], t[1], torch.zeros_like(t[2]))
    assert zsum.item() == 0.0 and zn.item() == 0.0


def test_bf16_logits_are_promoted_like_jax():
    logits, targets, mask = _inputs(3)
    lb = torch.tensor(logits).bfloat16()
    want_sum, _ = jlosses.smoothed_nll_loss(
        jnp.asarray(lb.float().numpy()).astype(jnp.bfloat16), targets, mask)
    got_sum, _ = losses.smoothed_nll_loss(lb, torch.tensor(targets),
                                          torch.tensor(mask))
    np.testing.assert_allclose(got_sum.item(), float(want_sum), rtol=1e-5)


@pytest.mark.parametrize("epsilon", [0.1, 0.0])
def test_gradient_matches_jax(epsilon):
    logits, targets, mask = _inputs(4)

    def jloss(x):
        s, n = jlosses.smoothed_nll_loss(x, targets, mask, epsilon)
        return s / jnp.maximum(n, 1.0)

    want = jax.grad(jloss)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    s, n = losses.smoothed_nll_loss(x, torch.tensor(targets),
                                    torch.tensor(mask), epsilon)
    (s / torch.clamp(n, min=1.0)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=1e-6)
    assert (x.grad[1] == 0).all()                     # the masked row
