"""The NLLB-MoE layout of the port (the port's own ``Seq2SeqConfig`` fields:
pre-LN blocks with a final LayerNorm a stack, an MoE bank every n-th layer
routed without drops at inference, ReLU, sinusoidal positions, a tied head
without a bias) against the plain reference ``benchmark/reference/
nllb_moe.py`` (loaded by path: the benchmark's own tests are not part of
this run), on a tiny NLLB-shaped config in fp32: hidden 64, 4 heads, FFN
128, 8 experts top-2, an MoE every 2nd layer, 4 + 4 layers, vocabulary 256.

Tolerances: the port and the reference compute the same fp32 products in a
different association (the port's fused projections, its cache, its
grouped gather and ``index_add``; the reference's per-token loops), so they
differ by fp32 rounding, relative ~1e-6 of a value's magnitude; every
comparison allows 2e-5 of the largest magnitude, some ten times that and far
below any difference of routing or of a position (a swapped expert or a
shifted sinusoid row moves values by 1e-2 or more at these widths, as the
bf16 test shows for rounding alone).

``-m cuda``: the decode kernels at the benchmark cell's shapes (K4 and K6
at D = 128, K2 at E = 2048) against their plain versions, and the grouped
expert products at segments of 0 to ~1000 rows against the loop.
"""

import dataclasses
import hashlib
import importlib.util
import json
import os
import sys

import pytest
import torch

from imagetranslate_tpu_torch.decoding.beam import beam_search
from imagetranslate_tpu_torch.models import moe as moe_mod
from imagetranslate_tpu_torch.models.config import PORT_FIELDS, Seq2SeqConfig
from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
from imagetranslate_tpu_torch.models.transformer import (
    pad_bias,
    sinusoid_table,
    token_positions,
)
from imagetranslate_tpu_torch.train.weights import (
    flax_from_state_dict,
    random_params,
    state_dict_from_flax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")


def _load_reference():
    sys.path.insert(0, BENCH)
    try:
        spec = importlib.util.spec_from_file_location(
            "bench_reference_nllb_moe",
            os.path.join(BENCH, "reference", "nllb_moe.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        from reference.decode import served_gap, teacher_forced_logits
    finally:
        sys.path.remove(BENCH)
    return mod, served_gap, teacher_forced_logits


REF, SERVED_GAP, TEACHER_FORCED = _load_reference()
TOL = 2e-5      # of the largest magnitude: fp32 rounding (module docstring)


def nllb_config(**kw) -> Seq2SeqConfig:
    base = dict(vocab_size=256, num_languages=2, hidden_size=64, num_heads=4,
                intermediate_size=128, max_position_embeddings=64,
                enc_layers=4, dec_layers=4, dropout=0.1,
                attention_dropout=0.1, layer_norm_eps=1e-5,
                initializer_range=0.1, pad_id=1, bos_id=0, eos_id=2,
                tie_embed=True, dtype="float32", kv_cache_dtype="float32",
                use_pallas_attention=False, decode_attention_impl="fused",
                moe_experts=8, moe_top_k=2, moe_every=2, pre_layer_norm=True,
                activation="relu", embedding="nllb", output_bias=False,
                moe_inference="dropless", moe_inference_scale=0.8)
    base.update(kw)
    return Seq2SeqConfig(**base)


def weights(cfg: Seq2SeqConfig, seed: int = 0):
    """The JAX initializers' draw, with the biases and LayerNorms moved off
    their zeros and ones so that every term is exercised."""
    sd = state_dict_from_flax(random_params(cfg, seed), cfg)
    gen = torch.Generator().manual_seed(seed + 1)
    out = {}
    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("bias", "bi", "bo") or ("LayerNorm" in k or ".ln." in k):
            v = v + 0.1 * torch.randn(v.shape, generator=gen)
        out[k] = v
    return out


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    cfg = nllb_config()
    sd = weights(cfg)
    model = Seq2Seq(cfg)
    model.load_state_dict(sd, strict=True)
    model.eval()
    return cfg, model, REF.NllbMoeRef(sd, dataclasses.asdict(cfg)), sd


def _source(B: int = 3, S: int = 9, seed: int = 3):
    gen = torch.Generator().manual_seed(seed)
    src = torch.randint(4, 256, (B, S), generator=gen)
    keep = torch.ones((B, S), dtype=torch.bool)
    keep[1, 6:] = False
    keep[2, 3:] = False
    src[~keep] = 1
    return src, keep


def _close(got, want, tol=TOL):
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= tol * scale


def test_encoder_states_match_the_reference(pair):
    cfg, model, ref, _ = pair
    src, keep = _source()
    with torch.no_grad():
        got = model.encode(src, keep, torch.zeros(3, dtype=torch.long))
        want = ref.encode(src, keep)
    _close(got[keep], want[keep])


def test_teacher_forced_logits_match_the_reference(pair):
    cfg, model, ref, _ = pair
    src, keep = _source()
    gen = torch.Generator().manual_seed(5)
    tgt = torch.randint(4, 256, (3, 7), generator=gen)
    tgt[:, 0] = 6
    with torch.no_grad():
        got = model(src, keep, tgt, torch.ones_like(tgt, dtype=torch.bool),
                    torch.zeros(3, dtype=torch.long),
                    torch.ones(3, dtype=torch.long))
        enc = ref.encode(src, keep)
        want = TEACHER_FORCED(ref, enc, keep, tgt.tolist(), [1] * 3, "cpu")
    for r in range(3):
        _close(got[r], want[r])


def test_cached_decode_steps_match_the_full_forward(pair):
    """init_cache + decode_step over a fixed token sequence, two beams a
    source: each step's logits are the reference's full forward at that
    position (the cache's K/V and its sinusoid positions pad + 1 + step)."""
    cfg, model, ref, _ = pair
    src, keep = _source()
    K, n = 2, 8
    gen = torch.Generator().manual_seed(9)
    tgt = torch.randint(4, 256, (3, n), generator=gen)
    with torch.no_grad():
        enc = model.encode(src, keep, torch.zeros(3, dtype=torch.long))
        cache = model.init_cache(enc, 3 * K, 16)
        langs = torch.ones(3 * K, dtype=torch.long)
        steps = []
        for i in range(n - 1):
            prev = tgt[:, i].repeat_interleave(K)[:, None]
            steps.append(model.decode_step(prev, cache, i, pad_bias(keep),
                                           langs, 0))
        renc = ref.encode(src, keep)
        want = TEACHER_FORCED(ref, renc, keep, tgt.tolist(), [1] * 3, "cpu")
    for i, logits in enumerate(steps):
        for r in range(3):
            for b in range(K):
                _close(logits[r * K + b], want[r][i])


def test_beam_decode_serves_tokens_in_the_references_top_k(pair):
    """``beam_search`` through the cache, K4's and K6's plain versions and
    the dropless bank: every served token lies among the reference's K best
    at its position, up to fp32 rounding."""
    cfg, model, ref, _ = pair
    src, keep = _source()
    with torch.no_grad():
        enc = model.encode(src, keep, torch.zeros(3, dtype=torch.long))
        langs = torch.ones(3, dtype=torch.long)
        best, lengths = beam_search(
            model, enc, keep, torch.full((3,), 6), langs, keep.sum(1),
            beam_width=4, max_len=16, pad_id=1, eos_id=-1)
        renc = ref.encode(src, keep)
        seqs = [best[r, :int(lengths[r])].tolist() for r in range(3)]
        want = TEACHER_FORCED(ref, renc, keep, seqs, [1] * 3, "cpu")
    for r, s in enumerate(seqs):
        assert len(s) == int(torch.floor(1.3 * keep[r].sum() + 5))
        scale = want[r].abs().max().item()
        assert SERVED_GAP(want[r], s[1:], 4) <= TOL * scale


def _bank(cfg, seed=0, starve=None):
    """An MoE bank with random weights (and biases); ``starve``: an expert
    whose router row points away from positive inputs."""
    bank = moe_mod.MoEFeedForward(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in bank.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=gen))
        if starve is not None:
            bank.router.weight[starve] = -1.0
    return bank.eval()


def _reference_bank(bank, cfg):
    W = {f"L.moe.{k}": v.detach().float()
         for k, v in bank.state_dict().items()}
    W["encoder.embeddings.word_embeddings.weight"] = torch.zeros(1, 1)
    return REF.NllbMoeRef(W, dataclasses.asdict(cfg))


def test_dropless_bank_matches_a_per_expert_loop():
    """The sort, device offsets, gather, grouped products and index_add of
    the bank without drops against the reference's per-token top-2 and loop
    over the experts, with an expert that no token chooses."""
    cfg = nllb_config()
    bank = _bank(cfg, starve=7)
    x = torch.randn(40, cfg.hidden_size).abs()
    probs = torch.softmax(x @ bank.router.weight.t(), -1)
    top2 = torch.topk(probs, 2, dim=-1).indices
    assert not (top2 == 7).any() and len(set(top2.flatten().tolist())) > 3
    with torch.no_grad():
        got = bank._dropless(x)
    want = _reference_bank(bank, cfg).moe(x, "L")
    _close(got, want)


def test_dropless_bank_counts_its_choices_and_loads():
    from imagetranslate_tpu_torch.utils import profiling

    cfg = nllb_config()
    bank = _bank(cfg, seed=2)
    x = torch.randn(2, 10, cfg.hidden_size)
    profiling.drain()
    profiling.enable()
    try:
        with torch.no_grad():
            bank(x)
    finally:
        profiling.disable()
    spans, counts = profiling.drain()
    assert counts["moe.choices"] == 40
    h = bank.ln(x.reshape(-1, cfg.hidden_size))
    top2 = torch.topk(torch.softmax(h @ bank.router.weight.t(), -1), 2,
                      dim=-1).indices
    assert counts["moe.max_load"] == torch.bincount(
        top2.flatten(), minlength=8).max().item()
    assert [s[0] for s in spans] == ["moe.route", "moe.dispatch",
                                     "moe.experts", "moe.combine"]


def test_expert_product_takes_empty_segments():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(10, 16, generator=gen)
    w = torch.randn(4, 16, 8, generator=gen)
    offs = torch.tensor([3, 3, 10, 10], dtype=torch.int32)
    want = torch.cat([x[:3] @ w[0], x[3:10] @ w[2]])
    assert torch.allclose(moe_mod.expert_product(x, w, offs), want)


def test_experts_in_bf16_fail_the_tolerance():
    """The same bank with its products in bf16 (weights and inputs rounded)
    lies far outside the fp32 tolerance above: the tolerance tells the
    precision apart."""
    cfg = nllb_config()
    bank = _bank(cfg, seed=1)
    x = torch.randn(40, cfg.hidden_size)
    want = _reference_bank(bank, cfg).moe(x, "L")
    low = _bank(dataclasses.replace(cfg, dtype="bfloat16"), seed=1)
    with torch.no_grad():
        for p, q in zip(low.parameters(), bank.parameters()):
            p.copy_(q)
        got = low._dropless(x.bfloat16()).float()
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err > 10 * TOL


@pytest.mark.parametrize("every,layers,want", [(2, 4, [1, 3]),
                                               (4, 8, [3, 7]),
                                               (1, 3, [0, 1, 2]),
                                               (4, 3, [])])
def test_moe_banks_sit_where_i_plus_1_divides(every, layers, want):
    cfg = nllb_config(moe_every=every, enc_layers=layers, dec_layers=layers)
    with torch.device("meta"):
        model = Seq2Seq(cfg)
    for stack in ("encoder.encoder", "decoder.decoder"):
        got = sorted({int(k.split(".")[3]) for k in model.state_dict()
                      if k.startswith(stack + ".layer.") and ".moe." in k})
        assert got == want


def test_sinusoid_positions_with_padding(pair):
    """fairseq's positions: pad + the rank among a row's real tokens (the
    first real token at 2), pad at padding, whose row is zero; the table is
    the reference's; a packed row's 0-based positions shift by pad + 1."""
    cfg, model, ref, _ = pair
    keep = torch.tensor([[True, True, True, False],
                         [True, False, False, False]])
    pos = token_positions(cfg, keep)
    assert pos.tolist() == [[2, 3, 4, 1], [2, 1, 1, 1]]
    assert token_positions(cfg, keep, torch.tensor(
        [[0, 1, 0, 0], [0, 0, 0, 0]])).tolist() == [[2, 3, 2, 1],
                                                    [2, 1, 1, 1]]
    table = sinusoid_table(70, 64, 1)
    assert torch.equal(table[1], torch.zeros(64))
    assert torch.allclose(table, REF.sinusoid(70, 64, 1))
    ids = torch.tensor([[9, 8, 7, 1], [5, 1, 1, 1]])
    with torch.no_grad():
        got = model.embeddings(ids, pos, None)
    _close(got, ref.embed(ids, pos))


def test_checkpoint_crosses_and_config_json_keeps_the_layout(tmp_path, pair):
    from imagetranslate_tpu_torch.train.checkpoint import (
        load_config,
        load_params,
        save_params,
    )

    cfg, model, _, sd = pair
    save_params(str(tmp_path), cfg, flax_from_state_dict(sd, cfg))
    assert load_config(str(tmp_path)) == cfg
    back = state_dict_from_flax(load_params(str(tmp_path)), cfg)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_a_training_step_raises(pair):
    """Training the dropless bank is not built: a step names the config and
    the missing pieces, and does not fall back to the capacity path."""
    from imagetranslate_tpu_torch.train import step as pstep
    from imagetranslate_tpu_torch.train.optimizer import build_optimizer

    cfg, _, _, sd = pair
    model = Seq2Seq(cfg, param_dtype=torch.float32)
    model.load_state_dict(sd)
    optim = build_optimizer(lr=1e-3)
    state = pstep.create_train_state(dict(model.named_parameters()), optim)
    step = pstep.make_mt_train_step(model, optim)
    src, keep = _source()
    batch = {"src": src, "src_mask": keep, "dst": src, "dst_mask": keep,
             "src_langs": torch.zeros(3, dtype=torch.long),
             "dst_langs": torch.ones(3, dtype=torch.long),
             "row_mask": torch.ones(3, dtype=torch.bool)}
    with pytest.raises(NotImplementedError,
                       match="dropless.*128|dropless.*training") as err:
        step(state, batch, torch.Generator().manual_seed(0))
    assert "capacity" in str(err.value) and "z-loss" in str(err.value)


# The state_dict keys of the benchmark's two configurations as they were
# before the NLLB layout's fields (sha256 of the keys in order, one a line).
KEYS = {
    "mt-bert-base": (259, "31a04eca9ed1e213ba2b52d6808218d42e75bd61273c81bd5"
                          "6733766689b1615"),
    "caption-resnet18": (366, "06ceac305f2eb9e0d36bb728dc0a4353fde3aa5969ca"
                              "3778a3bf3867b97591f6"),
}


@pytest.mark.parametrize("name", sorted(KEYS))
def test_existing_configs_keep_their_layout(name):
    from imagetranslate_tpu_torch.models.captioning import ImageSeq2Seq

    raw = json.load(open(os.path.join(BENCH, "configs", name + ".json")))
    fields = {f.name for f in dataclasses.fields(Seq2SeqConfig)}
    cfg = Seq2SeqConfig(**{k: v for k, v in raw.items() if k in fields})
    defaults = Seq2SeqConfig(vocab_size=8)
    for f in PORT_FIELDS:
        assert f not in raw and getattr(cfg, f) == getattr(defaults, f)
    assert not any(f in json.loads(cfg.to_json()) for f in PORT_FIELDS)
    cls = ImageSeq2Seq if name.startswith("caption") else Seq2Seq
    with torch.device("meta"):
        keys = list(cls(cfg).state_dict())
    digest = hashlib.sha256("\n".join(keys).encode()).hexdigest()
    assert (len(keys), digest) == KEYS[name]


def test_bad_layout_values_are_refused():
    for bad in (dict(activation="swish"), dict(embedding="rope"),
                dict(moe_inference="sometimes"), dict(moe_every=0)):
        with pytest.raises(ValueError):
            nllb_config(**bad)


# ---------------- on the card ----------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("R,n", [(2664, 1), (2664, 23), (2664, 47),
                                 (1000, 63), (32, 231)])
def test_k4_at_head_width_128(R, n):
    """K4 at the cell's 16 heads of 128 against its plain version."""
    _card()
    from imagetranslate_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(R + n)
    q = torch.randn(R, 16, 128, device="cuda", generator=gen).bfloat16()
    k = torch.randn(R, n, 16, 128, device="cuda", generator=gen).bfloat16()
    v = torch.randn(R, n, 16, 128, device="cuda", generator=gen).bfloat16()
    before = da.LAUNCHES
    got = da.decode_attention(q, k, v)
    torch.cuda.synchronize()
    assert da.LAUNCHES == before + 1
    want = da.decode_attention_reference(q, k, v)
    tol = 2.0 ** -7 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(666, 32), (250, 128), (86, 176)])
def test_k6_at_head_width_128(B, S):
    """K6 at 4 beams, 16 heads of 128, the cell's source buckets."""
    _card()
    from imagetranslate_tpu_torch.ops import cross_attention as xa

    gen = torch.Generator(device="cuda").manual_seed(B + S)
    q = torch.randn(B * 4, 16, 128, device="cuda", generator=gen).bfloat16()
    k = torch.randn(B, S, 16, 128, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, S, 16, 128, device="cuda", generator=gen).bfloat16()
    keep = torch.ones(B, S, dtype=torch.bool, device="cuda")
    keep[::3, S // 2:] = False
    bias = pad_bias(keep)
    before = xa.LAUNCHES
    got = xa.cross_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert xa.LAUNCHES == before + 1
    want = xa.cross_attention_reference(q, k, v, bias)
    tol = 2.0 ** -7 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2664, 1000, 32])
def test_k2_at_width_2048(M):
    """K2 at E = 2048 over the cell's 42704-row slice, k = 4, no bias (the
    head's zero buffer), against its plain version."""
    _card()
    from imagetranslate_tpu_torch.ops import topk_project as tkp

    gen = torch.Generator(device="cuda").manual_seed(M)
    h = torch.randn(M, 2048, device="cuda", generator=gen).bfloat16()
    w = (0.02 * torch.randn(42704, 2048, device="cuda",
                            generator=gen)).bfloat16()
    b = torch.zeros(42704, device="cuda")
    val, idx, lse = tkp.project_topk(h, w, b, 4)
    rval, ridx, rlse = tkp.project_topk_reference(h, w, b, 4)
    torch.cuda.synchronize()
    assert torch.allclose(lse, rlse, atol=2e-3, rtol=0)
    assert torch.allclose(val, rval, atol=2e-3, rtol=0)
    same = (idx == ridx).float().mean().item()
    assert same > 0.99


@pytest.mark.cuda
def test_grouped_expert_products_on_the_card():
    """``torch._grouped_mm`` at the cell's widths (bf16, 2048 -> 8192 ->
    2048) with segments of 0 to ~1000 rows, against the loop."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    counts = torch.tensor([0, 1, 17, 0, 999, 64, 3, 0] * 2)
    offs = torch.cumsum(counts, 0).to(torch.int32).cuda()
    N = int(counts.sum())
    x = torch.randn(N, 2048, device="cuda", generator=gen).bfloat16()
    wi = (0.02 * torch.randn(16, 2048, 8192, device="cuda",
                             generator=gen)).bfloat16()
    got = moe_mod.expert_product(x, wi, offs)
    want = moe_mod.expert_product(x.cpu().float(), wi.cpu().float(),
                                  offs.cpu())
    torch.cuda.synchronize()
    tol = 2.0 ** -7 * want.abs().max().item()
    assert (got.float().cpu() - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_dropless_bank_makes_no_host_sync_on_the_card():
    """The bank's route, sort, offsets, gather, grouped products and
    combine run with the card's sync debug mode at "error"."""
    _card()
    cfg = nllb_config(dtype="bfloat16", kv_cache_dtype="bfloat16")
    bank = _bank(cfg, seed=3).cuda()
    x = torch.randn(64, 1, cfg.hidden_size, device="cuda").bfloat16()
    with torch.no_grad():
        want = bank(x)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = bank(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)


def test_arrays_above_the_chunk_limit_cross_as_flax_chunks_them(monkeypatch):
    """An NLLB-MoE bank's stacked experts (4.3 GB in bf16) exceed msgpack's
    1 GiB: the port writes and reads flax's chunked-array maps, here with
    both limits cut to 256 bytes, byte for byte as flax writes them."""
    import numpy as np
    from flax import serialization

    from imagetranslate_tpu_torch.train import checkpoint

    monkeypatch.setattr(checkpoint, "_CHUNK_LIMIT", 256)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    gen = np.random.RandomState(0)
    # Keys in sorted order, as flax's tree map leaves them.
    tree = {"a": {"small": gen.randn(4).astype(np.float32),
                  "wi": gen.randn(5, 7, 3).astype(np.float32)},
            "b": gen.randn(70).astype(np.float32)}
    ours = checkpoint.msgpack_dumps(tree)
    theirs = serialization.msgpack_serialize(tree)
    assert ours == theirs
    back = checkpoint.msgpack_loads(theirs)
    assert np.array_equal(back["a"]["wi"].numpy(), tree["a"]["wi"])
    assert np.array_equal(back["b"].numpy(), tree["b"])
    restored = serialization.msgpack_restore(ours)
    assert np.array_equal(restored["a"]["wi"], tree["a"]["wi"])
