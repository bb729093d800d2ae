"""The port's MT train step against the JAX package: the training path as a whole.

The same flax-initialised weights and the same batches (numpy seed) go through
both packages at ``tiny_config`` sizes, fp32, dropout 0:

- forward logits (atol 2e-5 / rtol 1e-5) and every parameter gradient (atol
  2e-6 + rtol 1e-4: fp32 sums in another order) for a padded batch, a packed
  batch and the model variants; packed rows equal unpacked rows per token;
- an 8-step loss trajectory of ``make_mt_train_step`` with accum 1 and 2
  (per-step loss rtol 1e-4), parameters compared at the end (atol 2e-4: eight
  Adam steps of 1e-3 amplify rounding where a gradient is near zero);
- checkpoints with ``opt_state.msgpack`` cross over in both directions: a
  state trained by one package resumes in the other and takes the same next
  step.

The attention key biases are left out of the parameter comparisons after
Adam steps: softmax is invariant to them, so their gradient is rounding noise
in both packages and Adam scales noise to full-size steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.data.packing import pack_mt_examples
from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.models.seq2seq import Seq2Seq as JaxSeq2Seq
from imagetranslate_tpu.ops.losses import smoothed_nll_loss as jax_loss
from imagetranslate_tpu.train import checkpoint as jckpt
from imagetranslate_tpu.train import optimizer as jopt
from imagetranslate_tpu.train import step as jstep
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
from imagetranslate_tpu_torch.ops.losses import smoothed_nll_loss
from imagetranslate_tpu_torch.train import checkpoint as ckpt
from imagetranslate_tpu_torch.train import optimizer as opt
from imagetranslate_tpu_torch.train import step as pstep
from imagetranslate_tpu_torch.train.weights import (
    flax_from_opt_state,
    flax_from_state_dict,
    opt_state_from_flax,
    random_params,
    state_dict_from_flax,
)

V, B, S, T = 48, 8, 9, 8
OPT = dict(lr=1e-3, warmup_updates=4, clip_norm=1.0)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """At these sizes one intra-op thread is the fastest, and the file's time
    stays steady when other test workers load every core (torch's thread pool
    spins against them otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass
class Batch:
    src: np.ndarray
    src_mask: np.ndarray
    dst: np.ndarray
    dst_mask: np.ndarray
    src_langs: np.ndarray
    dst_langs: np.ndarray
    row_mask: np.ndarray
    proposals: np.ndarray = None
    proposal_mask: np.ndarray = None


def _batch(seed, proposals=False):
    rng = np.random.RandomState(seed)
    src = rng.randint(5, V, (B, S)).astype(np.int32)
    dst = rng.randint(5, V, (B, T)).astype(np.int32)
    for i in range(B):
        src[i, rng.randint(4, S + 1):] = 0
        dst[i, rng.randint(3, T + 1):] = 0
    row_mask = np.ones(B, bool)
    row_mask[-1] = False                               # a padding row
    b = Batch(src, src != 0, dst, dst != 0, np.zeros(B, np.int32),
              np.ones(B, np.int32), row_mask)
    if proposals:
        b.proposals = rng.randint(5, V, (B, 4)).astype(np.int32)
        b.proposal_mask = rng.rand(B, 4) > 0.3
    return b


def _init(jcfg, b):
    model = JaxSeq2Seq(jcfg)
    kw = ({"proposals": b.proposals, "proposal_mask": b.proposal_mask}
          if b.proposals is not None else {})
    params = jax.device_get(model.init(
        jax.random.PRNGKey(1), b.src, b.src_mask, b.dst, b.dst_mask,
        b.src_langs, b.dst_langs, **kw))
    return model, params


def _port_model(cfg, params):
    model = Seq2Seq(cfg, param_dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(params, cfg))
    return model


def _noise_free(name):
    return ".self.key.bias" not in name


def _assert_tree_close(sd, tree, cfg, atol, rtol=0.0, skip_key_bias=False):
    want = state_dict_from_flax(jax.device_get(tree), cfg)
    assert set(sd) == set(want)
    for name, leaf in want.items():
        if skip_key_bias and not _noise_free(name):
            continue
        np.testing.assert_allclose(sd[name].detach().numpy(), leaf.numpy(),
                                   atol=atol, rtol=rtol, err_msg=name)


# ---------------- (d) forward and gradients ----------------

@pytest.mark.parametrize("variant", ["base", "tie_embed", "lang_dec",
                                     "proposals"])
def test_padded_forward_and_gradients_match_flax(variant):
    kw = {} if variant == "base" else {
        "use_proposals" if variant == "proposals" else variant: True}
    jcfg, cfg = jax_tiny_config(vocab_size=V, **kw), tiny_config(V, **kw)
    b = _batch(0, proposals=variant == "proposals")
    jmodel, params = _init(jcfg, b)
    jb = jstep.mt_batch_to_device(b)
    mask = jb["dst_mask"][:, 1:] & jb["row_mask"][:, None]

    def jloss(p):
        logits = jmodel.apply(
            p, jb["src"], jb["src_mask"], jb["dst"], jb["dst_mask"],
            jb["src_langs"], jb["dst_langs"],
            proposals=jb.get("proposals"),
            proposal_mask=jb.get("proposal_mask"), deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(0)})
        s, n = jax_loss(logits, jb["dst"][:, 1:], mask, 0.1)
        return s / jnp.maximum(n, 1.0), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    model = _port_model(cfg, params)
    pb = pstep.mt_batch_to_device(b, CPU)
    logits = model(pb["src"], pb["src_mask"], pb["dst"], pb["dst_mask"],
                   pb["src_langs"], pb["dst_langs"],
                   proposals=pb.get("proposals"),
                   proposal_mask=pb.get("proposal_mask"),
                   deterministic=False, rng=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=2e-5, rtol=1e-5)
    s, n = smoothed_nll_loss(logits, pb["dst"][:, 1:],
                             pb["dst_mask"][:, 1:] & pb["row_mask"][:, None])
    loss = s / torch.clamp(n, min=1.0)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    got = {k: torch.zeros_like(named[k]) if g is None else g
           for k, g in zip(named, grads)}
    _assert_tree_close(got, jgrads, cfg, atol=2e-6, rtol=1e-4)


def _examples(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.randint(5, V, rng.randint(3, 8)).tolist(),
             rng.randint(5, V, rng.randint(3, 7)).tolist(), 0, 1)
            for _ in range(n)]


def test_packed_forward_gradients_and_per_token_equality():
    """A packed batch through both packages (logits and gradients), and in
    the port each packed example's logits equal its own unpacked forward."""
    jcfg, cfg = jax_tiny_config(vocab_size=V), tiny_config(V)
    examples = _examples(3, 7)
    (pk,) = pack_mt_examples(examples, src_budget=24, dst_budget=20,
                             rows_per_batch=4)
    jmodel, params = _init(jcfg, _batch(0))
    jb = jstep.packed_mt_batch_to_device(pk)
    seg = jb["dst_seg"]
    mask = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] > 0)

    def jloss(p):
        logits = jmodel.apply(
            p, jb["src"], jb["src_seg"] > 0, jb["dst"], jb["dst_seg"] > 0,
            jb["src_langs"], jb["dst_langs"], tgt_positions=jb["dst_pos"],
            src_positions=jb["src_pos"], src_segments=jb["src_seg"],
            tgt_segments=jb["dst_seg"])
        s, n = jax_loss(logits, jb["dst"][:, 1:], mask, 0.1)
        return s / jnp.maximum(n, 1.0), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    model = _port_model(cfg, params)
    pb = pstep.packed_mt_batch_to_device(pk, CPU)
    logits = model(pb["src"], pb["src_seg"] > 0, pb["dst"], pb["dst_seg"] > 0,
                   pb["src_langs"], pb["dst_langs"],
                   tgt_positions=pb["dst_pos"], src_positions=pb["src_pos"],
                   src_segments=pb["src_seg"], tgt_segments=pb["dst_seg"])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=2e-5, rtol=1e-5)
    pseg = pb["dst_seg"]
    pmask = (pseg[:, 1:] == pseg[:, :-1]) & (pseg[:, 1:] > 0)
    assert np.array_equal(pmask.numpy(), np.asarray(mask))
    s, n = smoothed_nll_loss(logits, pb["dst"][:, 1:], pmask)
    loss = s / torch.clamp(n, min=1.0)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    _assert_tree_close(dict(zip(named, grads)), jgrads, cfg, atol=2e-6,
                       rtol=1e-4)

    # per token: every example alone, unpacked
    checked = 0
    with torch.no_grad():
        for r in range(pk.dst.shape[0]):
            for seg_id in range(1, int(pk.dst_seg[r].max()) + 1):
                s_ids = pk.src[r][pk.src_seg[r] == seg_id]
                d_ids = pk.dst[r][pk.dst_seg[r] == seg_id]
                alone = model(
                    torch.tensor(s_ids)[None],
                    torch.ones(1, len(s_ids), dtype=torch.bool),
                    torch.tensor(d_ids)[None],
                    torch.ones(1, len(d_ids), dtype=torch.bool),
                    torch.zeros(1, dtype=torch.int32),
                    torch.ones(1, dtype=torch.int32))[0]
                at = np.nonzero(pk.dst_seg[r] == seg_id)[0][:-1]
                np.testing.assert_allclose(
                    logits[r, at].detach().numpy(), alone.numpy(), atol=2e-5,
                    rtol=1e-5)
                checked += 1
    assert checked == len(examples)


# ---------------- (e) the trajectory ----------------

class Both:
    """The two packages' trainers-in-miniature on the same weights."""

    def __init__(self, accum):
        self.jcfg, self.cfg = jax_tiny_config(vocab_size=V), tiny_config(V)
        self.jmodel, params = _init(self.jcfg, _batch(0))
        self.joptim = jstep.wrap_accum(jopt.build_optimizer(**OPT), accum)
        self.jstate = jstep.create_train_state(params, self.joptim)
        self.jstep = jstep.make_mt_train_step(self.jmodel, self.joptim,
                                              donate=False)
        self.model = _port_model(self.cfg, params)
        self.optim = pstep.wrap_accum(opt.build_optimizer(**OPT), accum)
        self.state = pstep.create_train_state(
            dict(self.model.named_parameters()), self.optim)
        self.step = pstep.make_mt_train_step(self.model, self.optim)
        self.rng = torch.Generator().manual_seed(0)

    def jax_step(self, b):
        self.jstate, m = self.jstep(self.jstate, jstep.mt_batch_to_device(b),
                                    jax.random.PRNGKey(0))
        return float(m["sum_loss"]) / float(m["ntokens"])

    def port_step(self, b):
        self.state, m = self.step(self.state,
                                  pstep.mt_batch_to_device(b, CPU), self.rng)
        return m["sum_loss"].item() / m["ntokens"].item()

    def assert_same_params(self, atol):
        _assert_tree_close(self.model.state_dict(), self.jstate.params,
                           self.cfg, atol=atol, skip_key_bias=True)


@pytest.mark.parametrize("accum", [1, 2])
def test_loss_trajectory_and_final_parameters(accum):
    both = Both(accum)
    batches = [_batch(10 + i % 3) for i in range(8)]
    jl = [both.jax_step(b) for b in batches]
    pl = [both.port_step(b) for b in batches]
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert pl[-1] < pl[0] - 0.01                      # it learns
    assert both.state.step == int(both.jstate.step) == 8
    both.assert_same_params(atol=2e-4)
    inner = opt._inner(both.state.opt_state)
    assert inner.count == inner.schedule_count == 8 // accum


def test_all_masked_batch_and_refused_options():
    """n = max(n, 1): a batch whose rows are all padding gives loss 0 and a
    finite update, with the plain loss and with use_pallas_xent (once
    refused; now the fused loss, whose masked rows get a zero gradient)."""
    cfg = tiny_config(V)
    model = Seq2Seq(cfg, param_dtype=torch.float32)
    optim = opt.build_optimizer(**OPT)
    state = pstep.create_train_state(dict(model.named_parameters()), optim)
    b = _batch(0)
    b.row_mask[:] = False
    state, m = pstep.make_mt_train_step(model, optim)(
        state, pstep.mt_batch_to_device(b, CPU), torch.Generator())
    assert m["sum_loss"].item() == 0.0 and m["ntokens"].item() == 1.0
    assert all(torch.isfinite(p).all() for p in model.parameters())
    fused = Seq2Seq(tiny_config(V, use_pallas_xent=True),
                    param_dtype=torch.float32)
    assert pstep._loss_impl(fused) is not pstep._loss_impl(model)
    state = pstep.create_train_state(dict(fused.named_parameters()), optim)
    state, m = pstep.make_mt_train_step(fused, optim)(
        state, pstep.mt_batch_to_device(b, CPU), torch.Generator())
    assert m["sum_loss"].item() == 0.0 and m["ntokens"].item() == 1.0
    assert all(torch.isfinite(p).all() for p in fused.parameters())


def test_fp32_masters_with_bf16_compute_and_dropout():
    """A training model stores fp32 and computes in cfg.dtype; with dropout
    on, the step is a function of the generator's seed."""
    cfg = tiny_config(V, dtype="bfloat16", dropout=0.1, attention_dropout=0.1)
    losses = []
    for seed in (0, 0, 1):
        model = _port_model(cfg, random_params(cfg, 0))
        assert all(p.dtype == torch.float32 for p in model.parameters())
        pb = pstep.mt_batch_to_device(_batch(0), CPU)
        enc = model.encode(pb["src"], pb["src_mask"], pb["src_langs"])
        assert enc.dtype == torch.bfloat16
        optim = opt.build_optimizer(**OPT)
        state = pstep.create_train_state(dict(model.named_parameters()),
                                         optim)
        _, m = pstep.make_mt_train_step(model, optim)(
            state, pb, torch.Generator().manual_seed(seed))
        losses.append(m["sum_loss"].item())
        assert all(p.dtype == torch.float32 for p in model.parameters())
    assert losses[0] == losses[1] != losses[2]
    serving = Seq2Seq(cfg)
    assert serving.encoder.embeddings.word_embeddings.weight.dtype == \
        torch.bfloat16
    with pytest.raises(ValueError, match="rng"):
        serving(pb["src"], pb["src_mask"], pb["dst"], pb["dst_mask"],
                pb["src_langs"], pb["dst_langs"], deterministic=False)


# ---------------- (g) checkpoints cross over ----------------

def _jax_templates(both):
    return (jax.tree.map(jnp.zeros_like, both.jstate.params),
            jax.tree.map(jnp.zeros_like, both.jstate.opt_state))


@pytest.mark.parametrize("accum", [1, 2])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, accum):
    both = Both(accum)
    for i in range(3):
        both.jax_step(_batch(20 + i))
    jckpt.save_checkpoint(str(tmp_path), both.jcfg, both.jstate.params,
                          opt_state=both.jstate.opt_state, step=3,
                          best_metric=1.5)
    params, opt_tree, meta = ckpt.load_checkpoint(str(tmp_path),
                                                  with_opt_state=True)
    assert meta == {"step": 3, "best_metric": 1.5}
    both.model.load_state_dict(state_dict_from_flax(params, both.cfg))
    both.state.opt_state = opt_state_from_flax(opt_tree, both.optim,
                                               both.cfg)
    inner = opt._inner(both.state.opt_state)
    assert inner.count == inner.schedule_count == 3 // accum
    nxt = _batch(30)
    np.testing.assert_allclose(both.port_step(nxt), both.jax_step(nxt),
                               rtol=1e-5)
    both.assert_same_params(atol=2e-5)
    # without the optimizer state only the weights come back
    assert ckpt.load_checkpoint(str(tmp_path))[1] is None
    # a plain optimizer refuses an accumulating state and the reverse
    other = pstep.wrap_accum(opt.build_optimizer(**OPT), 3 - accum)
    with pytest.raises(ValueError, match="accumulation"):
        opt_state_from_flax(opt_tree, other, both.cfg)


@pytest.mark.parametrize("accum", [1, 2])
def test_port_checkpoint_resumes_in_jax(tmp_path, accum):
    both = Both(accum)
    for i in range(3):
        both.port_step(_batch(20 + i))
    ckpt.save_checkpoint(
        str(tmp_path), both.cfg,
        flax_from_state_dict(both.model.state_dict(), both.cfg),
        opt_state=flax_from_opt_state(both.state.opt_state, both.optim,
                                      both.cfg),
        step=3, best_metric=-1.0)
    params, opt_state, meta = jckpt.load_checkpoint(str(tmp_path),
                                                    *_jax_templates(both))
    assert meta == {"step": 3, "best_metric": -1.0}
    for leaf in jax.tree.leaves(params):
        assert leaf.dtype == jnp.float32               # fp32 masters
    both.jstate = jstep.TrainState(params=params, opt_state=opt_state,
                                   step=jnp.asarray(3, jnp.int32))
    nxt = _batch(30)
    np.testing.assert_allclose(both.port_step(nxt), both.jax_step(nxt),
                               rtol=1e-5)
    both.assert_same_params(atol=2e-5)


def test_core_subtree_fallback(tmp_path):
    """A text model loads from a multimodal checkpoint's ``core`` subtree."""
    cfg = tiny_config(V)
    tree = flax_from_state_dict(Seq2Seq(cfg).state_dict(), cfg)
    ckpt.save_checkpoint(str(tmp_path), cfg,
                         {"params": {"core": tree["params"],
                                     "image": {"w": torch.zeros(2)}}})
    back = ckpt.load_params(str(tmp_path))
    assert set(back["params"]) == set(tree["params"])
    Seq2Seq(cfg).load_state_dict(state_dict_from_flax(back, cfg))
