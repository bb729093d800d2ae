"""The cells this benchmark adds for NLLB-MoE and four-card training, on the
CPU: the NLLB cell's kind (``traffic/translate_moe.py``) at tiny widths
holds the program to ``reference/nllb_moe.py`` and catches a dropped choice
and the fp8 control; ``kernels/moe.py``'s least time at the cell's shapes,
worked by hand; the MoE load reader; the registry of both new cells and
their files. (The four-card kind runs in ``test_bench_dp4.py``.)"""

import copy
import json
import os
import re
import time

import pytest
import torch

import harness
from judge import limits

NL, DP = "nllb-moe-translate-beam4", "mt-train-packed-dp4"
BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
TINY = dict(vocab_size=96, hidden_size=32, num_heads=4, intermediate_size=64,
            max_position_embeddings=64, moe_experts=8, dtype="float32",
            kv_cache_dtype="float32")
TINY_TRAFFIC = dict(corpus_sentences=48, pass_batches=3, batch=400,
                    check_rows=4, length={"median": 8, "sigma": 0.5,
                                          "min": 4, "max": 30})
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_nllb(**config) -> harness.Cell:
    cell = copy.deepcopy(harness.load_cell(NL))
    cell.config.update(TINY, **config)
    cell.traffic.update(TINY_TRAFFIC)
    return cell


def checks_of(cell, seed=2 ** 31 + 11):
    out, checks = harness.run_cell(cell, seed, 0.2, False, CPU, time.time())
    return out, checks


def test_sound_run_is_correct():
    out, checks = checks_of(tiny_nllb())
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert set(checks) == {"topk_gap", "score_gap", "lse_gap",
                           "wrong_lengths", "dropped_choices", "route_excess"}
    assert checks["dropped_choices"]["value"] == 0
    assert out["attempted"] > 0 and out["failed"] == 0


def test_a_dropped_choice_is_caught(monkeypatch):
    """A bank whose offsets end one row short (a choice that never reaches
    its expert, its contribution zero) makes ``dropped_choices`` positive
    and the run not correct."""
    from imagetranslate_tpu_torch.models import moe

    class ShortEnds:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def cumsum(t, dim, **kw):
            out = torch.cumsum(t, dim, **kw)
            out[-1] -= 1
            return out

    monkeypatch.setattr(moe, "torch", ShortEnds())
    _, checks = checks_of(tiny_nllb())
    assert checks["dropped_choices"]["value"] > 0


def test_a_misrouted_choice_is_caught(monkeypatch):
    """A router that takes each token's second and third experts in place
    of its first and second: ``route_excess`` (the replayed routing's check)
    lies far above its limit. The routers' logits spread as the cell's do
    (std 0.02 sqrt(2048), which at hidden 32 takes initializer_range
    0.16), since the limit is set in the cell's router logits."""
    from imagetranslate_tpu_torch.models import moe

    real = moe.MoEFeedForward.route_dropless

    def skip_best(bank, tokens):
        probs = torch.softmax(tokens.float() @ bank.router.weight.t(), -1)
        idx = torch.topk(probs, 3, dim=-1).indices[:, 1:]
        gates = probs.gather(1, idx)
        gates = gates / gates.sum(1, keepdim=True)
        real(bank, tokens)
        return [idx[:, 0], idx[:, 1]], [gates[:, 0], gates[:, 1]]

    monkeypatch.setattr(moe.MoEFeedForward, "route_dropless", skip_best)
    _, checks = checks_of(tiny_nllb(initializer_range=0.16))
    assert checks["route_excess"]["value"] > checks["route_excess"]["limit"]


def test_control_fails_on_the_cpu():
    """The program holds; the reference in fp8 in its place does not. At
    these widths initializer_range 0.3 makes an expert's output as large as
    the residual it joins and spreads the logits, as the cell's published
    widths do at 0.02."""
    cell = tiny_nllb(initializer_range=0.3)
    got = harness.kind_module(cell).control(cell, 2 ** 31 + 21, CPU,
                                            faults=True)
    lim = limits(NL)
    assert all(v <= lim[k] for k, v in got["program"].items() if k in lim)
    assert any(v > lim[k] for k, v in got["control_fp8"].items()
               if k in lim), got
    # The program with its router in bf16 reads its routing apart from the
    # fp32 program's (the tiny program is fp32 throughout).
    assert got["bf16_router"]["route_excess"] > got["program"][
        "route_excess"]


def test_fitted_router_spreads_tokens_that_agree():
    """Calls whose tokens share one large component, a call's own offset
    (a decode step's position) and differ mostly along one direction: the
    seed's draw sends a call's tokens to a few experts; the fitted router
    is blind to the mean and the calls' offsets, its logits spread as the
    draw's do over LayerNorm'd input (std 0.02 sqrt(H)), and each call's
    tokens reach nearly every expert, the busiest taking less than half of
    what the draw's busiest takes, summed over the calls (as
    ``moe_load.decode`` sums them)."""
    kind = harness.kind_module(tiny_nllb())
    g = torch.Generator().manual_seed(3)
    H, E, T, C = 64, 16, 512, 8

    def randn(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    common, along = 3.0 * randn(H), randn(H)
    calls = []
    for _ in range(C):
        x = (common + 2.0 * randn(H) + randn(T, 1) * along
             + 0.1 * randn(T, H))
        calls.append(x / x.pow(2).mean(1, keepdim=True).sqrt())
    X = torch.cat(calls)
    draw = 0.02 * torch.randn(E, H, generator=g)
    counts = torch.full((C,), float(T), dtype=torch.float64)
    sums = torch.stack([x.sum(0) for x in calls])
    fit = kind.fitted(draw, counts, sums, X.t() @ X / (C * T), 0.02)
    assert fit.dtype == draw.dtype and fit.shape == draw.shape

    def used(w, x):
        top = (x @ w.to(torch.float64).t()).topk(2, dim=1).indices
        return torch.bincount(top.flatten(), minlength=E)

    for x in calls:
        assert int((used(draw, x) > 0).sum()) <= 6
        assert int((used(fit, x) > 0).sum()) >= E - 1
        assert float(used(fit, x).max()) < 4 * 2 * T / E
    assert sum(float(used(fit, x).max()) for x in calls) < 0.5 * sum(
        float(used(draw, x).max()) for x in calls)
    w = fit.to(torch.float64)
    assert float((X.mean(0) @ w.t()).abs().max()) < 1e-3
    assert float((X @ w.t()).std()) == pytest.approx(0.02 * H ** 0.5,
                                                     rel=0.05)


def test_reference_reads_the_fitted_routers():
    """The session serves the fitted routers, not the seed's draw, and the
    reference's weights carry the same values."""
    cell = tiny_nllb()
    kind = harness.kind_module(cell)
    s = kind.Session(cell, 2 ** 31 + 11, CPU)
    W = s.weights()
    own = s.model.state_dict()
    names = [n for n in own if n.endswith(".moe.router.weight")]
    assert sorted(s.routers) == sorted(names) and len(names) == 2
    draw = {}
    kind.fill(s.specs, s.seed, CPU, cell.config["initializer_range"],
              lambda name, rows, t: draw.setdefault(name, t))
    for name in names:
        assert torch.equal(W[name], own[name].float())
        assert not torch.allclose(W[name], draw[name].float())


def test_a_program_without_the_layout_exits_cleanly(monkeypatch):
    """A program whose config lacks the layout's fields (the parent of the
    change that added them) exits with 5 before it builds a model."""
    import dataclasses

    from imagetranslate_tpu_torch.models import config as port_config

    kind = harness.kind_module(tiny_nllb())
    fields = [f for f in dataclasses.fields(port_config.Seq2SeqConfig)
              if f.name != "moe_inference"]
    monkeypatch.setattr(dataclasses, "fields", lambda cls: fields)
    with pytest.raises(SystemExit) as e:
        kind.require_layout(tiny_nllb().config)
    assert e.value.code == 5


def test_moe_bound_by_hand():
    """At the decode bucket (4096 beam rows, 8192 choices, every expert with
    rows) the fc1 product reads 128 x 2048 x 8192 bf16 weights (4.295 GB),
    the 8192 rows in (33.6 MB) and out (134.2 MB): 1.3322 ms at 3.35 TB/s,
    above 2 x 8192 x 2048 x 8192 = 274.9 GFLOP at 989 TFLOP/s (0.2779 ms);
    fc2 the same with the widths swapped. With 96 of the experts empty, a
    quarter of the weights: 0.3706 ms. The sum reads the offsets once, and
    the roofline reader takes it as a number."""
    import readers

    spec = harness.load_module(os.path.join(harness.HERE, "kernels",
                                            "moe.py"), "k")
    bound = spec.LAUNCHES["expert_product"]
    x = torch.empty(8192, 2048, dtype=torch.bfloat16, device="meta")
    w = torch.empty(128, 2048, 8192, dtype=torch.bfloat16, device="meta")
    full = torch.arange(1, 129, dtype=torch.int32) * 64
    nbytes = (128 * 2048 * 8192 + 8192 * 2048 + 8192 * 8192) * 2
    assert nbytes == 4_462_739_456
    assert float(bound(x, w, full)) == pytest.approx(nbytes / 3.35e12,
                                                     rel=1e-12)
    assert float(bound(x, w, full)) == pytest.approx(1.3322e-3, rel=1e-4)
    h = torch.empty(8192, 8192, dtype=torch.bfloat16, device="meta")
    wo = torch.empty(128, 8192, 2048, dtype=torch.bfloat16, device="meta")
    assert float(bound(h, wo, full)) == pytest.approx(nbytes / 3.35e12,
                                                      rel=1e-12)
    # 256 rows at every fourth expert, none at the others.
    few = torch.cummax(torch.tensor([256 * (i // 4 + 1) if i % 4 == 0
                                     else 0 for i in range(128)]),
                       0).values.to(torch.int32)
    quarter = (32 * 2048 * 8192 + 8192 * 2048 + 8192 * 8192) * 2
    assert float(bound(x, w, few)) == pytest.approx(quarter / 3.35e12,
                                                    rel=1e-12)
    assert float(bound(x, w, few)) == pytest.approx(0.3706e-3, rel=1e-3)
    acc = 0.0
    acc += bound(x, w, full)
    acc += bound(h, wo, few)
    total = (nbytes + quarter) / 3.35e12
    assert readers.roofline("moe")({"kernels": {"moe": (acc, total)}}) \
        == pytest.approx(100.0)
    assert re.compile(spec.TRACE_NAMES).search(
        "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_"
        "relu_bf16_64x64_32x6_tn_align8>") is None
    assert re.compile(spec.TRACE_NAMES).search(
        "_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_"
        "sm9xINS_4gemm6kernel13GemmUniversalINS5_17GroupProblemShapeIN4cute")


def test_moe_load_reader():
    reader = harness.load_module(os.path.join(
        harness.HERE, "metrics", "moe_load.decode.py"), "m").read
    assert reader({}) is None
    assert reader({"moe": {"max_load": 0.0, "choices": 0.0,
                           "experts": 128}}) is None
    # Two calls of 8192 choices over 128 experts (mean segment 64) whose
    # largest segments were 96 and 160: (96 + 160) / (2 x 64) = 200 %.
    assert reader({"moe": {"max_load": 256.0, "choices": 16384.0,
                           "experts": 128}}) == pytest.approx(200.0)


def test_new_cells_and_their_files_load_by_name():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert cells[NL]["chips"] == 1 and cells[DP]["chips"] == 4
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)
    for name in (NL, DP):
        cell = harness.load_cell(name)
        assert harness.kind_module(cell).run
        assert harness.kind_module(cell).control
        assert limits(name)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                        "peak_mem_gib"}
        for m in cell.per_layer:
            assert hasattr(harness.load_module(os.path.join(
                harness.HERE, "metrics", m["name"] + ".py"), "m"), "read")
    nl = harness.load_cell(NL)
    assert {m["name"] for m in nl.end_to_end} == {"decode_tok_s",
                                                  "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in nl.per_layer} == {
        "step_ms.decode", "mfu.decode", "k2_roofline", "k4_roofline",
        "k6_roofline", "idle_share.decode", "moe_roofline",
        "moe_load.decode"}
    dp = harness.load_cell(DP)
    assert {m["name"] for m in dp.end_to_end} == {
        "train_tok_s", "train_step_ms_p95", "peak_mem_gib", "setup_s"}
    assert dp.traffic["world"] == 4 and dp.traffic["mesh"] == "4x1"
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200


def test_nllb_config_at_published_widths():
    entry = next(c for c in BENCH["configs"] if c["name"] == "nllb-moe-54b")
    data = json.load(open(os.path.join(harness.ROOT, entry["file"])))
    pub = data["published"]
    cfg = harness.seq2seq_config(data)
    assert (cfg.hidden_size, cfg.num_heads, cfg.head_dim,
            cfg.intermediate_size, cfg.moe_experts, cfg.moe_top_k,
            cfg.moe_every) == (pub["d_model"], pub["encoder_attention_heads"],
                               128, pub["encoder_ffn_dim"],
                               pub["num_experts"], 2,
                               pub["encoder_sparse_step"])
    assert sorted(entry["reduced"]) == sorted(data["reduced_from"])
    for key, (was, now) in data["reduced_from"].items():
        assert data[key] == now
    cards = data["deployment_cards"]
    assert data["vocab_size"] == -(-pub["vocab_size"] // cards // 16) * 16
    assert 4 * 6 == pub["encoder_layers"] == pub["decoder_layers"]
    assert data["enc_layers"] == data["dec_layers"] == pub[
        "encoder_layers"] // cards
    assert (cfg.pad_id, cfg.bos_id, cfg.eos_id) == (
        pub["pad_token_id"], pub["bos_token_id"], pub["eos_token_id"])
    assert cfg.moe_inference_scale == 1 - pub["moe_token_dropout"]
    assert len(entry["source"]) <= 200 and data["assumed"]
