"""The plain reference against the program at tiny sizes on the CPU, in
fp32, where the two must agree to rounding: the dropout masks, the
translation model's training forward and three training steps, the decode
path's logits, and the ResNet grid."""

import dataclasses

import numpy as np
import pytest
import torch

import harness
from reference import philox
from reference.model import DropoutStream, Seq2SeqRef
from reference.resnet import resnet_grid
from reference.train import train_steps
from weights import make_weights, specs_of

CPU = torch.device("cpu")
TINY = dict(vocab_size=64, hidden_size=32, num_heads=4, intermediate_size=64,
            max_position_embeddings=64, enc_layers=2, dec_layers=2,
            dtype="float32", kv_cache_dtype="float32")


def config(**kw):
    c = dict(harness.load_cell("mt-train-packed").config)
    c.update(TINY)
    c.update(kw)
    return c


@pytest.mark.parametrize("seed,shape", [(3, (2, 3, 5, 7)),
                                        (2 ** 33 + 5, (1, 2, 9, 16))])
def test_keep_mask_is_the_programs(seed, shape):
    from imagetranslate_tpu_torch.ops.train_attention import keep_mask

    assert torch.equal(philox.keep_mask(0.1, seed, *shape),
                       keep_mask(0.1, seed, *shape))


def _packed_batch(c, seed):
    import textgen
    from imagetranslate_tpu_torch.data.packing import pack_mt_examples

    rng = np.random.default_rng(seed)
    lens = [5, 9, 4, 12, 7, 6, 10, 3 + 2]
    ex = [(s, t, 0, 1) for s, t in zip(
        textgen.sentences(np.array(lens), 5, c["vocab_size"], rng),
        textgen.sentences(np.array(lens[::-1]), 6, c["vocab_size"], rng))]
    return pack_mt_examples(ex, src_budget=24, dst_budget=24,
                            rows_per_batch=3)


def test_training_forward_matches_with_dropout():
    from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
    from reference.train import batch_inputs, objective

    c = config()
    cfg = harness.seq2seq_config(c)
    model = Seq2Seq(cfg, device=CPU, param_dtype=torch.float32)
    W = make_weights(specs_of(model), 7, CPU)
    model.load_state_dict(W)
    b = _packed_batch(c, 1)[0]
    t = {k: torch.as_tensor(getattr(b, k)) for k in
         ("src", "src_seg", "src_pos", "dst", "dst_seg", "dst_pos",
          "src_langs", "dst_langs")}
    logits = model(t["src"], t["src_seg"] > 0, t["dst"], t["dst_seg"] > 0,
                   t["src_langs"], t["dst_langs"], tgt_positions=t["dst_pos"],
                   src_positions=t["src_pos"], src_segments=t["src_seg"],
                   tgt_segments=t["dst_seg"], deterministic=False,
                   rng=torch.Generator().manual_seed(11))
    seg = t["dst_seg"]
    mask = ((seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] > 0)).float()
    from imagetranslate_tpu_torch.ops.losses import smoothed_nll_loss

    want, n = smoothed_nll_loss(logits, t["dst"][:, 1:], mask, 0.1)
    ref = Seq2SeqRef(W, c)
    drop = DropoutStream(torch.Generator().manual_seed(11), CPU, 0.1, 0.1)
    got, n_ref = objective(ref, batch_inputs(b, CPU), drop, 0.1)
    assert float(n) == float(n_ref)
    gap = abs(float(got) - float(want))
    assert gap <= 1e-5 * abs(float(want))
    # Another seed draws other masks: the agreement is the masks'.
    drop = DropoutStream(torch.Generator().manual_seed(12), CPU, 0.1, 0.1)
    other, _ = objective(ref, batch_inputs(b, CPU), drop, 0.1)
    assert abs(float(other) - float(want)) > 100 * gap


@pytest.mark.parametrize("layout", ["packed", "bucketed"])
def test_three_steps_match_the_trainer(layout):
    from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
    from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer
    from imagetranslate_tpu_torch.train.weights import flax_from_state_dict
    from vocab import StandInVocab

    import judge

    c = config()
    c["train"] = dict(c["train"], warmup=4, lr=1e-3)
    cfg = harness.seq2seq_config(c)
    if layout == "packed":
        batches = _packed_batch(c, 2)
    else:
        from imagetranslate_tpu_torch.data.loader import MTBatcher
        import textgen

        rng = np.random.default_rng(2)
        lens = np.array([5, 6, 6, 7, 9, 9, 11, 4, 8])
        ex = [(s, t, 0, 1) for s, t in zip(
            textgen.sentences(lens, 5, 64, rng),
            textgen.sentences(lens + 1, 6, 64, rng))]
        batches = MTBatcher(ex, max_batch=60, capacity_mb=600).batches
    batches = (batches * 3)[:3]
    with torch.device("meta"):
        specs = specs_of(Seq2Seq(cfg, param_dtype=torch.float32))
    W = make_weights(specs, 5, CPU)
    tr = MTTrainer(cfg, StandInVocab(64), params=flax_from_state_dict(W, cfg),
                   lr=c["train"]["lr"], warmup=4, clip=1.0,
                   label_smoothing=0.1, seed=9,
                   device=CPU)
    from imagetranslate_tpu_torch.train.step import (
        mt_batch_to_device,
        packed_mt_batch_to_device,
    )

    to_dev = (packed_mt_batch_to_device if layout == "packed"
              else mt_batch_to_device)
    prog = {"loss": []}
    for i, b in enumerate(batches):
        tr.state, m = tr.mt_step(tr.state, to_dev(b, CPU), tr.rng)
        prog["loss"].append(float(m["sum_loss"] / m["ntokens"]))
        if i == 0:
            mu = tr.state.opt_state.mu
            prog["grad"] = {k: float(v.norm()) / 0.1 for k, v in mu.items()}
            prog["grad_vec"] = {k: v / 0.1 for k, v in mu.items()}
    prog["delta"] = {k: float((p.detach() - W[k]).norm())
                     for k, p in tr.state.params.items()}
    ref = train_steps(W, c, batches, 9, CPU)
    numbers = judge.train_numbers(prog, ref)
    assert numbers["loss_gap"] < 1e-5, numbers
    assert numbers["grad_gap"] < 1e-4, numbers
    assert numbers["grad_diff"] < 1e-4, numbers
    assert numbers["delta_gap"] < 1e-3, numbers


def test_decode_logits_match_the_decode_steps():
    """The reference's teacher-forced logits equal the program's cached
    decode steps over the same tokens (fp32, plain attention)."""
    from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
    from imagetranslate_tpu_torch.models.transformer import pad_bias
    from reference.decode import teacher_forced_logits

    c = config()
    cfg = harness.seq2seq_config(c, dtype="float32")
    model = Seq2Seq(cfg, device=CPU).eval()
    W = make_weights(specs_of(model), 4, CPU)
    model.load_state_dict(W)
    src = torch.tensor([[5, 9, 30, 41, 4, 0], [5, 11, 12, 13, 14, 4]])
    keep = src != 0
    seqs = [[6, 20, 21, 22, 23], [6, 40, 41, 42, 43]]
    with torch.no_grad():
        enc = model.encode(src, keep, torch.zeros(2, dtype=torch.long))
        cache = model.init_cache(enc, 2, 8)
        steps = []
        for i in range(4):
            prev = torch.tensor([[s[i]] for s in seqs])
            steps.append(model.decode_step(prev, cache, i, pad_bias(keep),
                                           torch.ones(2, dtype=torch.long)))
        ref = Seq2SeqRef(W, c)
        pos = torch.arange(6)[None].expand(2, 6)
        renc = ref.encode(src, pos, torch.zeros_like(src),
                          keep[:, None, None, :])
        got = teacher_forced_logits(ref, renc, keep, seqs, [1, 1], CPU)
    want = torch.stack(steps, dim=1)
    for r in range(2):
        torch.testing.assert_close(got[r], want[r], rtol=1e-4, atol=1e-5)


def test_resnet_grid_matches():
    from imagetranslate_tpu_torch.models.resnet import ResNetGrid

    net = ResNetGrid(32, depth=1, img_size=64, dtype=torch.float32,
                     device=CPU).eval()
    W = make_weights([("image_model." + k, s, d)
                      for k, s, d in specs_of(net)], 3, CPU)
    net.load_state_dict({k[len("image_model."):]: v for k, v in W.items()})
    from imagetranslate_tpu_torch.data.images import normalize_uint8

    images = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = net(normalize_uint8(images))
        got = resnet_grid(W, images)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_weights_follow_the_seed():
    from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq

    cfg = harness.seq2seq_config(config())
    with torch.device("meta"):
        specs = specs_of(Seq2Seq(cfg))
    a, b = make_weights(specs, 1, CPU), make_weights(specs, 1, CPU)
    c = make_weights(specs, 2, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = "encoder.embeddings.word_embeddings.weight"
    assert not torch.equal(a[w], c[w])
    assert abs(float(a[w].float().std()) - 0.02) < 2e-3
    assert dataclasses.is_dataclass(cfg)
