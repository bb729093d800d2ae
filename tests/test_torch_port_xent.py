"""The port's fused label-smoothed cross-entropy against the JAX package's
Pallas kernel.

The same numpy-seeded logits, targets and mask go through
``smoothed_nll_loss_pallas`` (the Pallas kernels in interpret mode on the CPU,
or its XLA rows where the shape does not tile) and through the port's
``smoothed_nll_loss_fused`` (its plain version on a CPU tensor): the sum to
rtol 1e-5, the count equal, the gradient to atol 1e-6 / rtol 1e-4 (fp32 sums
over the vocabulary in another order); for bf16 logits the gradient to one
bf16 ulp. An MT step with ``use_pallas_xent`` on equals the step with it off.
The CUDA kernels are held against the plain version in the ``cuda``-marked
test, which skips without a card (``chip_smoke.py`` holds them at the
training shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.ops.xent_pallas import (
    smoothed_nll_loss_pallas,
    smoothed_xent_rows as jax_rows,
)
from imagetranslate_tpu_torch.ops import xent
from imagetranslate_tpu_torch.ops.losses import smoothed_nll_loss


def _inputs(shape, V, seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape, V) * 2).astype(np.float32)
    targets = rng.randint(0, V, shape).astype(np.int32)
    mask = rng.rand(*shape) > 0.3
    return logits, targets, mask


def _both(logits, targets, mask, eps, jdtype=jnp.float32,
          tdtype=torch.float32):
    """((sum, count, dlogits) of the JAX Pallas loss, the same of the
    port's), gradients of sum / count as fp32 numpy."""
    jx = jnp.asarray(logits).astype(jdtype)

    def jloss(x):
        s, n = smoothed_nll_loss_pallas(x, jnp.asarray(targets),
                                        jnp.asarray(mask), eps)
        return s / jnp.maximum(n, 1.0), (s, n)

    (_, (js, jn)), jg = jax.value_and_grad(jloss, has_aux=True)(jx)
    assert jg.dtype == jdtype
    x = torch.tensor(logits).to(tdtype).requires_grad_(True)
    s, n = xent.smoothed_nll_loss_fused(x, torch.tensor(targets),
                                        torch.tensor(mask), eps)
    (g,) = torch.autograd.grad(s / torch.clamp(n, min=1.0), x)
    assert g.dtype == tdtype and s.dtype == torch.float32
    return ((float(js), float(jn), np.asarray(jg.astype(jnp.float32))),
            (s.item(), n.item(), g.float().numpy()))


@pytest.mark.parametrize("shape,V,eps", [
    ((32,), 256, 0.1),        # the Pallas kernels, one vocab tile
    ((4, 8), 384, 0.1),       # [B, T, V] logits, three vocab tiles
    ((16,), 4096, 0.0),       # two 2048-wide tiles, plain NLL
    ((7,), 101, 0.1),         # ragged N and V: JAX takes its XLA rows
    ((24,), 84, 0.0),         # ragged V only
    ((1,), 128, 0.1),         # one row
])
def test_fused_loss_matches_pallas_fp32(shape, V, eps):
    logits, targets, mask = _inputs(shape, V, seed=len(shape) + V)
    (js, jn, jg), (s, n, g) = _both(logits, targets, mask, eps)
    np.testing.assert_allclose(s, js, rtol=1e-5)
    assert n == jn == mask.sum()
    np.testing.assert_allclose(g, jg, atol=1e-6, rtol=1e-4)
    assert (g.reshape(-1, V)[~mask.reshape(-1)] == 0).all()


@pytest.mark.parametrize("shape,V,eps", [((32,), 256, 0.1), ((7,), 101, 0.0)])
def test_fused_loss_matches_pallas_bf16(shape, V, eps):
    """bf16 logits (cfg.fp32_logits off): fp32 arithmetic inside, dx in
    bf16. Both round the same fp32 value, so they agree to one bf16 ulp."""
    logits, targets, mask = _inputs(shape, V, seed=3)
    (js, jn, jg), (s, n, g) = _both(logits, targets, mask, eps,
                                    jnp.bfloat16, torch.bfloat16)
    np.testing.assert_allclose(s, js, rtol=1e-5)
    assert n == jn
    np.testing.assert_allclose(g, jg, atol=1e-9, rtol=2.0 ** -7)


def test_rows_reference_and_backward_formula():
    """The per-row function equals JAX's rows and the port's unfused loss;
    the backward kernel's plain formula equals autograd; a target outside
    [0, V) matches no column (x_t = 0), as in the Pallas kernel."""
    logits, targets, mask = _inputs((16,), 256, seed=5)
    targets[3], targets[9] = -1, 256
    x = torch.tensor(logits, requires_grad=True)
    t = torch.tensor(targets)
    rows = xent.smoothed_xent_rows(x, t, 0.1)
    want = jax_rows(jnp.asarray(logits), jnp.asarray(targets), 0.1)
    np.testing.assert_allclose(rows.detach().numpy(), np.asarray(want),
                               rtol=1e-5)
    g = torch.tensor(np.random.RandomState(6).rand(16).astype(np.float32))
    g[2] = 0.0
    (auto,) = torch.autograd.grad(rows, x, g)
    hand = xent.smoothed_xent_backward_reference(x.detach(), t, g, 0.1)
    np.testing.assert_allclose(hand.numpy(), auto.numpy(), atol=1e-7,
                               rtol=1e-5)
    assert (hand[2] == 0).all()
    # rows with a target in range equal the unfused loss, one row at a time
    ok = np.ones(16, bool)
    ok[[3, 9]] = False
    for i in np.nonzero(ok)[0][:4]:
        s, _ = smoothed_nll_loss(x[i:i + 1], t[i:i + 1],
                                 torch.ones(1, dtype=torch.bool), 0.1)
        np.testing.assert_allclose(rows[i].item(), s.item(), rtol=1e-6)
    with pytest.raises(ValueError, match="cpu or cuda"):
        xent.smoothed_xent_rows(x.detach().to("meta"), t, 0.1)


def test_fused_loss_takes_a_broadcast_upstream_gradient():
    """The backward sees g as mask / n broadcast, not a dense tensor."""
    logits, targets, mask = _inputs((4, 5), 64, seed=7)
    x = torch.tensor(logits, requires_grad=True)
    rows = xent.smoothed_xent_rows(x.reshape(-1, 64),
                                   torch.tensor(targets).reshape(-1), 0.1)
    (g,) = torch.autograd.grad(rows, x, torch.ones(1).expand(20))
    assert g.shape == x.shape and torch.isfinite(g).all()
    np.testing.assert_allclose(g.sum(-1).numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("mode", ["mt", "mass"])
def test_train_step_with_the_fused_loss_equals_the_plain_step(mode):
    """``use_pallas_xent`` picks the fused loss in both steps; the step's
    loss and updated parameters equal the plain step's."""
    from imagetranslate_tpu_torch.models.config import tiny_config
    from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
    from imagetranslate_tpu_torch.train import optimizer as opt
    from imagetranslate_tpu_torch.train import step as pstep
    from imagetranslate_tpu_torch.train.weights import (
        random_params,
        state_dict_from_flax,
    )

    V, B, S = 96, 8, 12
    rng = np.random.RandomState(0)
    src = rng.randint(5, V, (B, S)).astype(np.int32)
    dst = rng.randint(5, V, (B, S)).astype(np.int32)
    src[:, 10:], dst[:3, 7:] = 0, 0
    ones = np.ones(B, bool)
    if mode == "mt":
        batch = {"src": src, "src_mask": src != 0, "dst": dst,
                 "dst_mask": dst != 0, "src_langs": np.zeros(B, np.int32),
                 "dst_langs": np.ones(B, np.int32), "row_mask": ones}
    else:
        batch = {"src": src, "src_mask": src != 0,
                 "langs": np.zeros(B, np.int32),
                 "lengths": (src != 0).sum(1).astype(np.int32),
                 "row_mask": ones}
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    out = {}
    for fused in (False, True):
        cfg = tiny_config(V, use_pallas_xent=fused)
        model = Seq2Seq(cfg, param_dtype=torch.float32)
        model.load_state_dict(state_dict_from_flax(random_params(cfg, 0),
                                                   cfg))
        optim = opt.build_optimizer(lr=1e-3, warmup_updates=4)
        state = pstep.create_train_state(dict(model.named_parameters()),
                                         optim)
        step = (pstep.make_mt_train_step(model, optim) if mode == "mt"
                else pstep.make_mass_train_step(model, optim, cfg))
        assert (pstep._loss_impl(model) is xent.smoothed_nll_loss_fused) \
            == fused
        _, m = step(state, batch, torch.Generator().manual_seed(1))
        out[fused] = (m["sum_loss"].item() / m["ntokens"].item(),
                      {k: v.detach().clone()
                       for k, v in model.state_dict().items()})
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-5)
    for name, p in out[False][1].items():
        if ".self.key.bias" in name:       # its gradient is rounding noise
            continue
        np.testing.assert_allclose(out[True][1][name].numpy(), p.numpy(),
                                   atol=2e-5, err_msg=name)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """On a card: the forward and backward kernels against the plain version
    at ragged shapes, both dtypes, eps 0 and 0.1, an out-of-range target and
    masked rows; loss rows within 1e-4 relative, dx within 1e-6 + 1e-4
    relative (fp32) or one bf16 ulp (bf16; plus 1e-8, the fp32 arithmetic's
    own error where exp(x - logZ) and eps / V nearly cancel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (sm_90): the CUDA kernels "
                    "have no interpret mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = xent.FWD_LAUNCHES, xent.BWD_LAUNCHES
    cases = 0
    for N, V in ((64, 32000), (13, 30522), (5, 32003), (1, 84), (9, 3)):
        for dtype in (torch.float32, torch.bfloat16):
            for eps in (0.0, 0.1):
                x = (torch.randn(N, V, generator=gen, device="cuda") * 3).to(
                    dtype)
                t = torch.randint(0, V, (N,), generator=gen, device="cuda")
                t[0] = V + 7
                g = torch.rand(N, generator=gen, device="cuda")
                g[N // 2] = 0.0
                leaf = x.clone().requires_grad_(True)
                rows = xent.smoothed_xent_rows(leaf, t, eps)
                (dx,) = torch.autograd.grad(rows, leaf, g)
                torch.cuda.synchronize()
                want = xent.smoothed_xent_rows_reference(x, t, eps)
                wdx = xent.smoothed_xent_backward_reference(x, t, g, eps)
                torch.testing.assert_close(rows, want, rtol=1e-4, atol=1e-5)
                if dtype == torch.float32:
                    torch.testing.assert_close(dx, wdx, rtol=1e-4, atol=1e-6)
                else:
                    torch.testing.assert_close(dx.float(), wdx.float(),
                                               rtol=2.0 ** -7, atol=1e-8)
                cases += 1
    assert (xent.FWD_LAUNCHES - before[0], xent.BWD_LAUNCHES - before[1]) \
        == (cases, cases)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        xent.smoothed_xent_rows(x.half(), t, 0.1)
