"""The port's Mixture-of-Experts FFN (models/moe.py) and its place in every
stack and training step, against the JAX package's (tests/test_moe.py pins
the same properties there).

fp32, ``tiny_config`` widths (2 + 2 layers at E=48 for the models), the same
numpy-drawn weights (``weights.*.random_params``) in both packages:

- one expert, top-1, is the dense FFN; a token past its expert's capacity
  leaves the bank as LayerNorm(residual); grouped routing equals one group
  while no expert overflows; capacity per group; the group sizes of
  ``_group_size``; a token count the group size does not divide; ties in the
  router go to the lowest expert index, as ``jnp.argmax`` gives them;
- the bank's output against flax's MoEFeedForward with tokens dropped, and
  an MoE ``Seq2Seq``'s logits, load-balance loss (the mean over the layers'
  calls) and the MT step's gradient over every parameter against flax
  (logits within 1e-4, gradients within 1e-6 + rtol 1e-4);
- the parameters hold no aux state and no aux is reported outside a
  training step; a dense model's steps are what they were (bit for bit);
- an MoE MT step learns and moves the router; the MoE beam decode gives the
  JAX tokens, also with ``decode_attention_impl="fused"``;
- SenSim, Caption2Image and the caption step fold the aux loss, equal to the
  JAX ``_apply_with_aux`` / ``_caption_apply_with_aux`` value;
- ``cli.train_mt --moe-experts --moe-top-k`` trains; its checkpoint loads in
  the JAX package and a JAX-saved one loads and translates in the port; the
  config's validation.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.decoding.beam import beam_search as jax_beam_search
from imagetranslate_tpu.models.config import Seq2SeqConfig as JaxSeq2SeqConfig
from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.models import moe as jmoe
from imagetranslate_tpu.models.seq2seq import Seq2Seq as JaxSeq2Seq
from imagetranslate_tpu.train import checkpoint as jckpt
from imagetranslate_tpu.train import step as jstep
from imagetranslate_tpu_torch.decoding.beam import beam_search
from imagetranslate_tpu_torch.models import moe
from imagetranslate_tpu_torch.models.config import Seq2SeqConfig, tiny_config
from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
from imagetranslate_tpu_torch.models.transformer import EncoderLayer
from imagetranslate_tpu_torch.train import checkpoint as ckpt
from imagetranslate_tpu_torch.train import optimizer as opt
from imagetranslate_tpu_torch.train import step as pstep
from imagetranslate_tpu_torch.train.weights import SEQ2SEQ

V, B, S, T = 48, 8, 10, 9
WIDTH = dict(hidden_size=48, num_heads=4, intermediate_size=96)
MOE = dict(moe_experts=4, moe_top_k=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: fastest at these sizes, and steady when other
    test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    kw = {"vocab_size": V, **WIDTH, **MOE, **kw}
    return tiny_config(**kw), jax_tiny_config(**kw)


def _bank_params(cfg, seed):
    """Random flax-layout MoEFeedForward params (a layer's ``ffn``)."""
    return SEQ2SEQ.random_params(cfg, seed)["params"]["encoder"][
        "layers_0"]["ffn"]


def _bank(cfg, p):
    """The port's bank with the flax-layout params ``p``."""
    bank = moe.MoEFeedForward(cfg, param_dtype=torch.float32)
    sd = {"router.weight": torch.as_tensor(np.asarray(p["router"]["kernel"])).T,
          "ln.weight": torch.as_tensor(np.asarray(p["ln"]["scale"])),
          "ln.bias": torch.as_tensor(np.asarray(p["ln"]["bias"]))}
    sd.update({k: torch.as_tensor(np.asarray(p[k]))
               for k in ("wi", "bi", "wo", "bo")})
    bank.load_state_dict(sd, strict=True)
    return bank


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_bank(jcfg, p, x):
    return np.asarray(jmoe.MoEFeedForward(jcfg).apply(
        {"params": jax.tree.map(jnp.asarray, p)}, jnp.asarray(x)))


# ---------------- the bank ----------------

def test_e1_top1_degenerates_to_dense_ffn():
    """One expert, top-1, capacity for every token: the bank is the dense
    FFN of the same weights (the gate is exactly 1)."""
    cfg, _ = _cfgs(moe_experts=1, moe_top_k=1, moe_capacity_factor=1.0)
    dense_cfg = dataclasses.replace(cfg, moe_experts=0)
    layer = EncoderLayer(dense_cfg, param_dtype=torch.float32)
    p = _bank_params(cfg, 1)
    bank = _bank(cfg, p)
    with torch.no_grad():
        layer.intermediate["dense"].weight.copy_(bank.wi[0].T)
        layer.intermediate["dense"].bias.copy_(bank.bi[0])
        layer.output["dense"].weight.copy_(bank.wo[0].T)
        layer.output["dense"].bias.copy_(bank.bo[0])
        layer.output["LayerNorm"].load_state_dict(bank.ln.state_dict())
        x = torch.as_tensor(_x((4, 6, cfg.hidden_size)))
        np.testing.assert_allclose(bank(x).numpy(), layer.ffn(x).numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_capacity_overflow_rides_residual():
    """Every token routed to expert 0 with a capacity below the token count:
    the tokens past the capacity leave as LayerNorm(residual) exactly, and
    the whole output is flax's."""
    cfg, jcfg = _cfgs(moe_experts=2, moe_top_k=1, moe_capacity_factor=0.51)
    H, n = cfg.hidden_size, 64
    p = _bank_params(cfg, 1)
    p["router"]["kernel"] = np.zeros((H, 2), np.float32)
    p["router"]["kernel"][0, 0] = 100.0
    x = np.abs(_x((1, n, H)))
    x[:, :, 0] = 1.0
    bank = _bank(cfg, p)
    with torch.no_grad():
        out = bank(torch.as_tensor(x))
        ln_only = bank.ln(torch.as_tensor(x))
    C = moe._capacity(n, cfg)
    assert C == jmoe._capacity(n, jcfg) < n
    assert torch.equal(out[0, C:], ln_only[0, C:])
    assert not torch.allclose(out[0, :C], ln_only[0, :C])
    np.testing.assert_allclose(out.numpy(), _jax_bank(jcfg, p, x), atol=1e-5)


def test_grouped_routing_matches_single_group_when_balanced():
    cfg1, _ = _cfgs(moe_capacity_factor=8.0, moe_group_size=0)
    cfg8 = dataclasses.replace(cfg1, moe_group_size=32)   # T=256 -> G=8
    p = _bank_params(cfg1, 1)
    x = torch.as_tensor(_x((4, 64, cfg1.hidden_size)))
    with torch.no_grad():
        out1 = _bank(cfg1, p)(x)
        out8 = _bank(cfg8, p)(x)
    np.testing.assert_allclose(out8.numpy(), out1.numpy(), atol=2e-6)


def test_grouped_capacity_is_per_group():
    cfg, jcfg = _cfgs(moe_group_size=64)
    assert moe._capacity(64, cfg) == moe._capacity(
        64, dataclasses.replace(cfg, moe_group_size=0)) == 40
    for n in (1, 7, 64, 100, 256, 1000):
        assert moe._capacity(n, cfg) == jmoe._capacity(n, jcfg)


@pytest.mark.parametrize("n, requested, want", [
    (8064, 256, 252), (256, 256, 256), (512, 256, 256), (63, 16, 9),
    (9973, 256, 1), (100, 0, 100), (8, 256, 8), (16128, 256, 256)])
def test_group_size_never_falls_back_to_one_global_group(n, requested, want):
    assert moe._group_size(n, requested) == jmoe._group_size(n, requested) \
        == want


@pytest.mark.parametrize("top_k, group, shape, factor, drops", [
    (2, 64, (4, 32), 0.25, True), (1, 64, (4, 32), 0.25, True),
    (3, 0, (3, 21), 0.3, True), (2, 16, (3, 21), 1.25, False)])
def test_bank_matches_flax(top_k, group, shape, factor, drops):
    """Groups of 64 tokens, one global group, and T = 63 tokens in groups of
    9 (a count the requested 16 does not divide): the output equals flax's,
    with the tokens over an expert's capacity dropped where ``drops``."""
    cfg, jcfg = _cfgs(moe_top_k=top_k, moe_group_size=group,
                      moe_capacity_factor=factor)
    p = _bank_params(cfg, 2)
    x = _x((*shape, cfg.hidden_size), seed=3)
    bank = _bank(cfg, p)
    T_ = shape[0] * shape[1]
    n = moe._group_size(T_, group)
    with torch.no_grad():
        out = bank(torch.as_tensor(x))
        _, _, _, slots, _ = bank.route(torch.as_tensor(x).reshape(
            T_ // n, n, -1))
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert any((s >= moe._capacity(n, cfg)).any() for s in slots) == drops
    np.testing.assert_allclose(out.numpy(), _jax_bank(jcfg, p, x), atol=1e-5)


def test_router_ties_go_to_the_lowest_index():
    """A zero router: every probability ties. The first choice is expert 0,
    the second expert 1 (argmax's first maximum, in both packages); with
    logits (1, 3, 3, 0) the choices are 1 then 2."""
    cfg, jcfg = _cfgs()
    H = cfg.hidden_size
    p = _bank_params(cfg, 1)
    p["router"]["kernel"] = np.zeros((H, 4), np.float32)
    bank = _bank(cfg, p)
    x = _x((2, 5, H))
    with torch.no_grad():
        _, idxs, gates, _, _ = bank.route(torch.as_tensor(x).reshape(1, 10,
                                                                     H))
        assert (idxs[0] == 0).all() and (idxs[1] == 1).all()
        assert torch.allclose(gates[0], torch.full((1, 10), 0.5))
        np.testing.assert_allclose(bank(torch.as_tensor(x)).numpy(),
                                   _jax_bank(jcfg, p, x), atol=1e-5)
        p["router"]["kernel"][0] = [1.0, 3.0, 3.0, 0.0]
        x1 = np.zeros((1, 4, H), np.float32)
        x1[..., 0] = 1.0
        _, idxs, _, _, _ = _bank(cfg, p).route(torch.as_tensor(x1))
    assert (idxs[0] == 1).all() and (idxs[1] == 2).all()
    assert torch.argmax(torch.tensor([0.25, 0.25, 0.5, 0.5])) == 2


# ---------------- the models and the steps ----------------

def _mt_batch(seed, n=B, src_len=S, tgt_len=T):
    r = np.random.RandomState(seed)
    sl = r.randint(src_len // 2, src_len + 1, (n,))
    dl = r.randint(tgt_len // 2, tgt_len + 1, (n,))
    row_mask = np.ones(n, bool)
    row_mask[-1] = False
    return {"src": r.randint(5, V, (n, src_len)).astype(np.int32),
            "src_mask": np.arange(src_len)[None, :] < sl[:, None],
            "dst": r.randint(5, V, (n, tgt_len)).astype(np.int32),
            "dst_mask": np.arange(tgt_len)[None, :] < dl[:, None],
            "src_langs": r.randint(0, 2, (n,)).astype(np.int32),
            "dst_langs": np.zeros(n, np.int32), "row_mask": row_mask}


def _torch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


_MT_ARGS = ("src", "src_mask", "dst", "dst_mask", "src_langs", "dst_langs")


def _port_model(cfg, params, cls=Seq2Seq, bridge=SEQ2SEQ):
    model = cls(cfg, param_dtype=torch.float32)
    model.load_state_dict(bridge.state_dict_from_flax(params, cfg),
                          strict=True)
    return model


class _Recording:
    """An optimizer that keeps the gradients it is handed (by name)."""
    chain = ()

    def init(self, params):
        return None

    def update(self, grads, state, params):
        self.grads = dict(zip(params, grads))


@pytest.fixture(scope="module")
def mt_setup():
    """An MoE Seq2Seq with per-group capacity drops (groups of 16, factor
    1), and the flax side's logits, aux and MT objective gradient."""
    cfg, jcfg = _cfgs(moe_group_size=16, moe_capacity_factor=1.0)
    params = SEQ2SEQ.random_params(cfg, 0)
    jm = JaxSeq2Seq(jcfg)
    b = _mt_batch(0)
    args = [b[k] for k in _MT_ARGS]

    @jax.jit
    def run(p):
        def objective(q):
            logits, aux = jstep._apply_with_aux(jm, q, *args)
            mask = jnp.asarray(b["dst_mask"][:, 1:] & b["row_mask"][:, None])
            sum_l, n = jstep.smoothed_nll_loss(logits, b["dst"][:, 1:], mask,
                                               epsilon=0.1)
            return sum_l / jnp.maximum(n, 1.0) + jcfg.moe_aux_weight * aux, (
                logits, aux)
        return jax.value_and_grad(objective, has_aux=True)(p)

    (loss, (logits, aux)), grads = jax.device_get(
        run(jax.tree.map(jnp.asarray, params)))
    return dict(cfg=cfg, jcfg=jcfg, params=params, jm=jm, loss=loss,
                logits=logits, aux=aux, grads=grads)


def test_moe_logits_aux_and_gradient_match_flax(mt_setup):
    cfg = mt_setup["cfg"]
    model = _port_model(cfg, mt_setup["params"])
    b = _torch(_mt_batch(0))
    with moe.collect_aux(model) as sink:
        logits = model(*[b[k] for k in _MT_ARGS])
    assert len(sink) == cfg.enc_layers + cfg.dec_layers
    np.testing.assert_allclose(logits.detach().numpy(), mt_setup["logits"],
                               atol=1e-4)
    aux = sum(sink) / len(sink)
    np.testing.assert_allclose(float(aux.detach()), float(mt_setup["aux"]),
                               rtol=1e-5)
    assert 1.0 <= float(aux.detach()) < cfg.moe_experts

    rec = _Recording()
    state = pstep.create_train_state(dict(model.named_parameters()), rec)
    step = pstep.make_mt_train_step(model, rec)
    state, m = step(state, b, torch.Generator())
    np.testing.assert_allclose(
        float(m["sum_loss"] / m["ntokens"]) + cfg.moe_aux_weight * float(
            aux.detach()), float(mt_setup["loss"]), rtol=1e-5)
    want = SEQ2SEQ.state_dict_from_flax(mt_setup["grads"], cfg)
    router = 0.0
    for name, g in rec.grads.items():
        assert torch.isfinite(g).all(), name
        if name.endswith(".key.bias"):      # softmax-invariant: rounding
            assert max(g.abs().max(), want[name].abs().max()) < 1e-6, name
            continue
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-6,
                                   rtol=1e-4, err_msg=name)
        if name.endswith("moe.router.weight"):
            router += float(g.abs().sum())
    assert router > 0


def test_parameters_hold_no_aux_state(mt_setup):
    """The MoE model's state is its parameters alone (the flax tree's keys),
    and outside ``collect_aux`` no bank reports or keeps a loss."""
    cfg = mt_setup["cfg"]
    model = _port_model(cfg, mt_setup["params"])
    assert set(model.state_dict()) == set(
        SEQ2SEQ.state_dict_from_flax(mt_setup["params"], cfg))
    assert not list(model.buffers())
    banks = [m for m in model.modules() if isinstance(m, moe.MoEFeedForward)]
    assert len(banks) == cfg.enc_layers + cfg.dec_layers
    with torch.no_grad():
        model(*[_torch(_mt_batch(1))[k] for k in _MT_ARGS])
    assert all(b.aux_sink is None for b in banks)


def test_dense_steps_are_unchanged_by_the_aux_plumbing():
    """A dense model reports no aux term, and three MT steps with dropout
    give the same bits as the objective computed by hand."""
    cfg = tiny_config(vocab_size=V, **WIDTH, dropout=0.1,
                      attention_dropout=0.1)
    params = SEQ2SEQ.random_params(cfg, 4)
    model = _port_model(cfg, params)
    assert pstep._with_aux(model, lambda: 1.0) == (1.0, None)
    ref = _port_model(cfg, params)
    optim, ref_optim = (opt.build_optimizer(lr=1e-3, warmup_updates=2)
                        for _ in range(2))
    state = pstep.create_train_state(dict(model.named_parameters()), optim)
    ref_state = pstep.create_train_state(dict(ref.named_parameters()),
                                         ref_optim)
    step = pstep.make_mt_train_step(model, optim)
    gen, ref_gen = torch.Generator().manual_seed(3), \
        torch.Generator().manual_seed(3)
    for i in range(3):
        b = _torch(_mt_batch(10 + i))
        state, m = step(state, b, gen)
        logits = ref(*[b[k] for k in _MT_ARGS], deterministic=False,
                     rng=ref_gen)
        mask = b["dst_mask"][:, 1:] & b["row_mask"][:, None]
        sum_l, n = pstep.smoothed_nll_loss(logits, b["dst"][:, 1:], mask,
                                           epsilon=0.1)
        pstep._descend(ref_state, ref_optim, sum_l / torch.clamp(n, min=1.0))
        assert torch.equal(m["sum_loss"], sum_l.detach())
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        assert torch.equal(p, q), name


def test_moe_train_step_learns_and_routes(mt_setup):
    cfg = mt_setup["cfg"]
    model = _port_model(cfg, mt_setup["params"])
    optim = opt.build_optimizer(lr=3e-3, warmup_updates=4)
    state = pstep.create_train_state(dict(model.named_parameters()), optim)
    step = pstep.make_mt_train_step(model, optim)
    r0 = model.encoder.encoder.layer[0].moe.router.weight.detach().clone()
    b = _torch(_mt_batch(0, n=16))
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(8):
        state, m = step(state, b, gen)
        losses.append(float(m["sum_loss"] / m["ntokens"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    r1 = model.encoder.encoder.layer[0].moe.router.weight
    assert float((r1.detach() - r0).abs().max()) > 0


@pytest.mark.parametrize("impl", ["onehot", "fused"])
@pytest.mark.parametrize("factor", [1.25, 0.3])
def test_moe_beam_decode_matches_jax(impl, factor):
    """Beam 4 over an MoE model (a wide initializer, so that rows stop at
    different lengths), with ample capacity and with drops among the
    B*K = 16 step tokens: the JAX tokens, and the same tokens twice."""
    cfg, jcfg = _cfgs(initializer_range=0.15, moe_capacity_factor=factor,
                      decode_attention_impl=impl)
    params = SEQ2SEQ.random_params(cfg, 7)
    model = _port_model(cfg, params).eval()
    jm = JaxSeq2Seq(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    n = 4
    b = _mt_batch(5, n=n, src_len=6)
    first = np.full(n, 6, np.int32)
    sizes = b["src_mask"].sum(1).astype(np.int32)
    jenc = jm.apply(jp, b["src"], b["src_mask"], b["src_langs"],
                    method=JaxSeq2Seq.encode)
    want = jax_beam_search(jm, jp, jenc, b["src_mask"], first,
                           b["dst_langs"], sizes, beam_width=4, max_len=12,
                           pad_id=0, eos_id=4)
    tb = _torch(b)
    with torch.no_grad():
        enc = model.encode(tb["src"], tb["src_mask"], tb["src_langs"])
    outs = [beam_search(model, enc, tb["src_mask"], torch.as_tensor(first),
                        tb["dst_langs"], torch.as_tensor(sizes),
                        beam_width=4, max_len=12, pad_id=0, eos_id=4)
            for _ in range(2)]
    for best, lengths in outs:
        np.testing.assert_array_equal(best.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(want[1]))
    assert len(set(np.asarray(want[1]).tolist())) > 1


def test_sensim_and_caption2image_steps_fold_the_aux():
    """Both models' aux equals the JAX ``_apply_with_aux`` value on the same
    weights, and one step of each trains finitely with it."""
    from imagetranslate_tpu.models.caption2image import (
        Caption2Image as JaxC2I,
    )
    from imagetranslate_tpu.models.sensim import SenSim as JaxSenSim
    from imagetranslate_tpu_torch.models.caption2image import (
        GRID_SLOTS,
        Caption2Image,
    )
    from imagetranslate_tpu_torch.models.sensim import SenSim
    from imagetranslate_tpu_torch.train.weights import CAPTION2IMAGE, SENSIM

    cfg, jcfg = _cfgs()
    r = np.random.RandomState(1)
    src = r.randint(5, V, (B, S)).astype(np.int32)
    mask, langs = np.ones((B, S), bool), np.zeros(B, np.int32)
    optim = opt.build_optimizer(lr=2e-3)
    for name, cls, jcls, bridge, make in (
            ("sensim", SenSim, JaxSenSim, SENSIM,
             pstep.make_sensim_train_step),
            ("c2i", Caption2Image, JaxC2I, CAPTION2IMAGE,
             pstep.make_caption2image_train_step)):
        params = bridge.random_params(cfg, 2)
        args = (src, mask, langs) + ((src, mask, langs)
                                     if name == "sensim" else ())
        _, jaux = jstep._apply_with_aux(jcls(jcfg),
                                        jax.tree.map(jnp.asarray, params),
                                        *args)
        model = _port_model(cfg, params, cls, bridge)
        out, aux = pstep._with_aux(model, model,
                                   *[torch.as_tensor(a) for a in args])
        np.testing.assert_allclose(float(aux.detach()),
                                   cfg.moe_aux_weight * float(jaux),
                                   rtol=1e-5)
        batch = {"src": src, "src_mask": mask, "src_langs": langs,
                 "dst": src, "dst_mask": mask, "dst_langs": langs,
                 "row_mask": np.ones(B, bool),
                 "target_grid": r.randn(B, GRID_SLOTS,
                                        cfg.hidden_size).astype(np.float32)}
        state = pstep.create_train_state(dict(model.named_parameters()),
                                         optim)
        state, m = make(model, optim)(state, _torch(batch),
                                      torch.Generator())
        assert np.isfinite(float(m["sum_loss"])) and state.step == 1


def test_moe_caption_step_trains_with_aux():
    """The caption step of an MoE captioner: the aux of its training forward
    equals the JAX ``_caption_apply_with_aux`` value, and six steps lower
    the caption loss."""
    from imagetranslate_tpu.models.captioning import (
        ImageSeq2Seq as JaxImageSeq2Seq,
    )
    from imagetranslate_tpu_torch.models.captioning import ImageSeq2Seq
    from imagetranslate_tpu_torch.train.weights import CAPTION

    cfg, jcfg = _cfgs(img_size=32)
    variables = CAPTION.random_params(cfg, 0)
    r = np.random.RandomState(0)
    n, t = 8, 8
    batch = {"images": r.rand(n, 32, 32, 3).astype(np.float32),
             "captions": r.randint(5, V, (n, t)).astype(np.int32),
             "caption_mask": np.ones((n, t), bool),
             "langs": np.zeros(n, np.int32), "row_mask": np.ones(n, bool)}
    args = [batch[k] for k in ("images", "captions", "caption_mask",
                               "langs")]
    _, updates, jaux = jstep._caption_apply_with_aux(
        JaxImageSeq2Seq(jcfg), jax.tree.map(jnp.asarray, variables), *args,
        train=True, method=JaxImageSeq2Seq.caption_forward)
    model = ImageSeq2Seq(cfg, param_dtype=torch.float32)
    model.load_state_dict(CAPTION.state_dict_from_flax(variables, cfg),
                          strict=True)
    _, aux = pstep._with_aux(model, model.caption_forward,
                             *[torch.as_tensor(a) for a in args], train=True)
    np.testing.assert_allclose(float(aux.detach()),
                               cfg.moe_aux_weight * float(jaux), rtol=1e-5)
    assert float(jaux) > 0
    optim = opt.build_optimizer(lr=2e-3)
    state = pstep.create_caption_train_state(model, optim)
    step = pstep.make_caption_train_step(model, optim)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(6):
        state, m = step(state, _torch(batch), gen)
        losses.append(float(m["sum_loss"] / m["ntokens"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


# ---------------- config, checkpoints and the CLI ----------------

def test_config_validation():
    with pytest.raises(ValueError, match="moe_top_k=3"):
        Seq2SeqConfig(vocab_size=100, moe_experts=2, moe_top_k=3)
    with pytest.raises(ValueError, match="moe_group_size"):
        Seq2SeqConfig(vocab_size=100, moe_experts=2, moe_group_size=-1)
    cfg = Seq2SeqConfig(vocab_size=100, moe_experts=8, moe_top_k=2)
    assert Seq2SeqConfig.from_json(cfg.to_json()) == cfg


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A tokenizer (<aa>, <bb>) and a copy-task .mt file."""
    from imagetranslate_tpu_torch.data import binarize
    from imagetranslate_tpu_torch.text.processor import TextProcessor

    words = ["alpha", "beta", "gamma", "delta", "epsi", "zeta", "theta"]
    d = tmp_path_factory.mktemp("moe")
    rng = np.random.RandomState(0)
    rows = [" ".join(words[j] for j in rng.randint(0, 7, rng.randint(2, 7)))
            for _ in range(40)]
    (d / "train.txt").write_text("\n".join(rows) + "\n")
    TextProcessor().train_tokenizer([str(d / "train.txt")], 120,
                                    str(d / "tok"), {"<aa>": 0, "<bb>": 1})
    tp = TextProcessor(str(d / "tok"))
    binarize.write_mt(tp, str(d / "train.mt"), str(d / "train.txt"),
                      tp.token_id("<aa>"), str(d / "train.txt"),
                      tp.token_id("<bb>"))
    (d / "input.txt").write_text("\n".join(rows[:5]) + "\n")
    return d


def test_cli_train_mt_moe_crosses_to_jax_and_back(corpus, tmp_path):
    """``cli.train_mt --moe-experts 4 --moe-top-k 2`` trains two steps; the
    JAX package loads the checkpoint (params and Adam state) into an MoE
    model's templates; what JAX saves back loads in the port and
    ``cli.translate`` decodes with it."""
    from imagetranslate_tpu.train import optimizer as jopt
    from imagetranslate_tpu_torch.cli import train_mt, translate

    model = tmp_path / "m"
    train_mt.main(["--tok", str(corpus / "tok"), "--model", str(model),
                   "--train_mt", str(corpus / "train.mt"), "--embed", "48",
                   "--intermediate", "64", "--enc", "2", "--dec", "2",
                   "--batch", "600", "--warmup", "2", "--dtype", "float32",
                   "--step", "2", "--moe-experts", "4", "--moe-top-k", "2",
                   "--device", "cpu"])
    latest = str(model) + ".latest"
    cfg = ckpt.load_config(latest)
    assert (cfg.moe_experts, cfg.moe_top_k) == (4, 2)
    sd = SEQ2SEQ.state_dict_from_flax(ckpt.load_params(latest), cfg)
    assert "encoder.encoder.layer.0.moe.wi" in sd
    assert not any(".intermediate." in k for k in sd)
    tmpl = jax.tree.map(jnp.zeros_like, jax.tree.map(
        jnp.asarray, SEQ2SEQ.random_params(cfg, 0)))
    joptim = jopt.build_optimizer(lr=1e-4, warmup_updates=2)
    params, opt_state, meta = jckpt.load_checkpoint(
        latest, tmpl, jax.tree.map(jnp.zeros_like, joptim.init(tmpl)))
    assert meta["step"] == 2 and int(opt_state[1].count) == 2
    for name, leaf in SEQ2SEQ.state_dict_from_flax(
            jax.device_get(params), cfg).items():
        assert torch.equal(leaf, sd[name]), name
    jcfg = JaxSeq2SeqConfig.from_json(cfg.to_json())
    jckpt.save_checkpoint(str(tmp_path / "jax"), jcfg, params, step=2)
    back = SEQ2SEQ.state_dict_from_flax(
        ckpt.load_params(str(tmp_path / "jax")), cfg)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    translate.main(["--tok", str(corpus / "tok"), "--model",
                    str(tmp_path / "jax"), "--input",
                    str(corpus / "input.txt"), "--output",
                    str(tmp_path / "out.txt"), "--src", "aa", "--target",
                    "bb", "--beam", "2", "--device", "cpu"])
    assert len((tmp_path / "out.txt").read_text().splitlines()) == 5


_NO_JAX = """
import importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "imagetranslate_tpu")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)


sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
from imagetranslate_tpu_torch.cli import (
    get_sen_sim, train_sensim, train_txt2image, translate_img)
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.train import step
from imagetranslate_tpu_torch.train.trainer_sensim import SenSimTrainer
from imagetranslate_tpu_torch.train.trainer_txt2image import (
    Caption2ImageTrainer)

cfg = tiny_config(vocab_size=32, moe_experts=4, moe_top_k=2)
tr = SenSimTrainer(cfg, None, device="cpu")
ids = torch.randint(5, 32, (4, 6))
mask = torch.ones(4, 6, dtype=torch.bool)
langs = torch.zeros(4, dtype=torch.int32)
batch = {"src": ids, "src_mask": mask, "src_langs": langs, "dst": ids,
         "dst_mask": mask, "dst_langs": langs,
         "row_mask": torch.ones(4, dtype=torch.bool)}
tr.state, m = tr.step_fn(tr.state, batch, tr.rng)
assert torch.isfinite(m["sum_loss"]) and tr.state.step == 1
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
"""


def test_new_modules_run_without_jax():
    """The new models, trainers and CLIs import nothing of JAX or of the
    JAX package, and an MoE SenSim step runs without them."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": repo
           + os.pathsep + os.environ.get("PYTHONPATH", "")}
    subprocess.run([sys.executable, "-c", _NO_JAX], check=True, cwd=repo,
                   env=env, timeout=300)
