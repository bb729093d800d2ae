"""Smoke test of the PyTorch port (imagetranslate_tpu_torch) on one NVIDIA
H100: builds the CUDA kernels from this checkout, holds each against its plain
PyTorch version on the card, drives the serving path at BERT-base width
(encode -> KV-cached beam search, then the translate CLI end to end) and the
training path at the same width (MTTrainer steps, then the training CLI end to
end), and checks that each path went through its kernels.

Run from the root of a checkout, with one visible CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device  — card name and power limit, sm_90, TF32 off.
  2. build   — nvcc build of imagetranslate_tpu_torch/csrc/*.cu.
  3. kernel  — project_topk kernel vs its plain version: random cases at
               V=32000 and at ragged vocab sizes (84, 30522, 32003: a last
               chunk with fewer than k columns) with values and lse within
               1e-4 and indices equal wherever the next candidate is more
               than that away; exact tie cases across the kernel's 128-column
               chunks and in a ragged last chunk; both times at M=256,
               E=768, V=32000, k=4.
  4. decode  — BERT-base (V=32000, 768, 12 heads, 3072, 6+3 layers, bf16,
               random weights from a numpy seed) encode + beam_search at
               B=64, S=64, beam 4, L=88; LAUNCHES must equal the decode steps.
  5. cli     — a tokenizer trained on a generated corpus, a full-width
               checkpoint at its vocab, and cli.translate.main on 50 lines.
  6. kernel  — the fused dropout attention kernels (forward and backward) vs
     (K1)      their plain versions, element by element under the shared
               Philox mask: forward and dq, dk, dv, dbias at rate 0 and 0.1,
               both bias layouts, at the training shape (B=256, T=S=64, H=12,
               D=64), the packed shape (B=32, T=S=256), T != S, and ragged
               shapes at the gate's edges, and the decoder's shapes of phase
               7 (T=S=63; T=63, S=64); bf16 outputs within 2^-6 of the
               plain result's largest magnitude (a few bf16 ulps), fp32 dbias
               within 1e-4 of it. Mask statistics straight from the kernel
               (keep rate within 4 sigma, same seed -> same output, another
               seed -> another mask). Times of kernel, plain version and
               F.scaled_dot_product_attention (a yardstick, never on the
               path) at the training shape; kernel times at the packed shape.
  7. train   — MTTrainer at BERT-base width (fp32 masters, bf16 compute,
               dropout 0.1) on numpy batches of B=256, S=T=64 over the full
               vocabulary: 3 warm-up steps, 12 timed; the loss is finite and
               falls; forward and backward launches = 12 per step, each at a
               shape that phase 6 held against the plain version.
  8. train   — generated parallel corpus -> tokenizer -> data.binarize ->
     cli       cli.train_mt.main at full width -> cli.translate.main on the
               checkpoint it wrote -> load_checkpoint with the optimizer state.

``--profile`` adds a phase after 4 (one more decode) and one after 7 (three
more train steps) under torch.profiler, printing the device time by operation
and the device's busy share of that same profiled run (the union of kernel
intervals over its wall time), then three more train steps with input shapes
recorded, printing the dtype casts' (aten::copy_) device time by shape.

The second-to-last line is a JSON object describing each kernel, with its
launches on its main path, its times, and its bound: the larger of the bytes
it must move over 3.35 TB/s and its operations over 989 TFLOP/s (the H100's
published memory rate and dense bf16 rate). The last line is
{"ok": true, "device": {...}}. Without a CUDA card, or outside a checkout,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-4  # fp32 sums of 768 bf16 products taken in another order
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores, published


def bound(nbytes: float, flops: float):
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


def log(msg: str):
    print(msg, flush=True)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {card}")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs an sm_90 (Hopper) card, got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} capability {cap}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    from imagetranslate_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    log(f"[build] {_build.library_path()} in "
        f"{time.perf_counter() - t0:.1f} s")


def _time_ms(fn, iters: int = 50, setup=None) -> float:
    """Mean device time of fn with a cold L2 (a 64 MiB write between
    launches evicts the 49 MB weight, as the decoder layers do between two
    decode steps). ``setup`` runs before each timed call, untimed. The card
    is kept busy (~1 ms) while the host enqueues the events and fn, so that
    the time between the events is the device's and holds no wait for the
    host's enqueue (the Python wrapper takes longer than a short kernel)."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        if setup is not None:
            setup()
        fn()
    total = 0.0
    for _ in range(iters):
        if setup is not None:
            setup()
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def phase_kernel():
    import torch

    from imagetranslate_tpu_torch.ops import topk_project as tkp

    E, V = 768, 32000
    max_err = 0.0
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def random_case(M, k, vocab):
        h = torch.randn(M, E, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(vocab, E, generator=gen, device="cuda")
             * 0.05).bfloat16()
        b = torch.randn(vocab, generator=gen, device="cuda") * 0.1
        val, idx, lse = tkp.project_topk(h, w, b, k)
        torch.cuda.synchronize()
        rval, ridx, rlse = tkp.project_topk_reference(h, w, b, k + 1)
        logits = h.float() @ w.float().T + b
        err = max((val - rval[:, :k]).abs().max().item(),
                  (lse - rlse).abs().max().item())
        # The kernel's indices must name logits equal to its values...
        err_at = (logits.gather(1, idx.long()) - val).abs().max().item()
        # ...and equal the plain version's wherever no other candidate lies
        # within the tolerance.
        gaps = rval[:, :-1] - rval[:, 1:]                  # [M, k]
        clear = gaps[:, :k] > TOL
        clear[:, 1:] &= gaps[:, :k - 1] > TOL
        bad = (idx != ridx[:, :k]) & clear
        if (err > TOL or err_at > TOL or bad.any()
                or idx.dtype != torch.int32):
            raise AssertionError(
                f"kernel vs plain at M={M} k={k} V={vocab}: err {err:.3g}, "
                f"err_at_idx {err_at:.3g}, {int(bad.sum())} index "
                "mismatches")
        log(f"[kernel] M={M} k={k} V={vocab}: max abs err {err:.3g} "
            f"(at kernel idx {err_at:.3g}), indices ok")
        return max(err, err_at)

    cases = [(M, k, V) for M in (256, 100, 1) for k in (1, 4, 16)]
    # Ragged vocab sizes: the CLI phase's tokenizer vocab (one partial
    # chunk), BERT's 30522 (58 columns in the last chunk) and 32003 (3,
    # fewer than k).
    cases += [(256, k, 84) for k in (1, 4, 16)]
    cases += [(256, 4, 30522), (100, 16, 30522), (256, 4, 32003),
              (100, 16, 32003), (1, 16, 32003)]
    for M, k, vocab in cases:
        max_err = max(max_err, random_case(M, k, vocab))

    # Exact ties: the lowest vocab index wins, within a 128-column chunk and
    # across chunks (tests/test_topk_project.py:65-90, re-placed).
    def ties(M, k, top, low=(), lv=2.0, value=3.0, vocab=V):
        b = torch.zeros(vocab, device="cuda")
        b[list(top)] = value
        if low:
            b[list(low)] = lv
        h = torch.ones(M, E, device="cuda").bfloat16()
        w = torch.zeros(vocab, E, device="cuda").bfloat16()
        val, idx, lse = tkp.project_topk(h, w, b, k)
        rval, ridx, rlse = tkp.project_topk_reference(h, w, b, k)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ridx) and torch.equal(val, rval)
                and (lse - rlse).abs().max().item() <= TOL):
            raise AssertionError(f"tie case {top} {low} k={k}: kernel "
                                 f"{idx[0].tolist()} plain "
                                 f"{ridx[0].tolist()}")
        return idx[0].tolist()

    cases = [
        (dict(M=100, k=4, top=(5, 700, 1300, 2000), low=(9, 1290)),
         [5, 700, 1300, 2000]),
        (dict(M=100, k=6, top=(5, 700, 1300, 2000), low=(9, 1290)),
         [5, 700, 1300, 2000, 9, 1290]),
        (dict(M=7, k=4, top=(31999, 256, 255, 128, 127)),
         [127, 128, 255, 256]),
        (dict(M=7, k=2, top=(126, 127, 128, 129), value=1.0), [126, 127]),
        (dict(M=256, k=16, top=tuple(range(127, V, 128))),
         list(range(127, 16 * 128, 128))),
        (dict(M=1, k=16, top=(), value=0.0), list(range(16))),
        # A ragged last chunk (32000..32002) holding fewer columns than k.
        (dict(M=100, k=5, top=(32002, 32000, 31999, 5), vocab=32003),
         [5, 31999, 32000, 32002, 0]),
        # One partial chunk: the CLI phase's vocab.
        (dict(M=3, k=16, top=(83, 80, 2), low=(81,), vocab=84),
         [2, 80, 83, 81, 0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]),
    ]
    for kw, want in cases:
        got = ties(**kw)
        if got != want:
            raise AssertionError(f"tie case {kw}: got {got}, want {want}")
    log(f"[kernel] {len(cases)} exact tie cases ok")

    M, k = 256, 4
    h = torch.randn(M, E, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(V, E, generator=gen, device="cuda") * 0.05).bfloat16()
    b = torch.randn(V, generator=gen, device="cuda") * 0.1
    runs = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = (tkp.project_topk_reference if name == "plain"
              else tkp.project_topk)
        runs[name].append(_time_ms(lambda: fn(h, w, b, k)))
    ms = sum(runs["kernel"]) / 2
    plain_ms = sum(runs["plain"]) / 2
    log(f"[kernel] M={M} E={E} V={V} k={k}: kernel {runs['kernel']} ms, "
        f"plain (cuBLAS fp32 + logsumexp + stable sort) {runs['plain']} ms")
    bound_ms, bound_by = bound(M * E * 2 + V * E * 2 + V * 4 + M * (8 * k + 4),
                               2.0 * M * E * V)
    # No single PyTorch call computes projection + top-k + logsumexp.
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def bert_base(vocab_size: int):
    from imagetranslate_tpu_torch.models.config import Seq2SeqConfig

    return Seq2SeqConfig(vocab_size=vocab_size, num_languages=2,
                         dropout=0.0, attention_dropout=0.0)


def build_model(cfg, device, seed=SEED):
    from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
    from imagetranslate_tpu_torch.train.weights import (
        random_params,
        state_dict_from_flax,
    )

    model = Seq2Seq(cfg, device=device)
    model.load_state_dict(state_dict_from_flax(random_params(cfg, seed), cfg))
    return model.eval()


def run_decode(model, B, S, K, device, seed=SEED):
    """encode + beam_search as cli/translate.py calls them, with EOS outside
    the vocab so every row decodes to its full limit (bench.py's rule).
    Returns (best, lengths, decode steps, seconds)."""
    import numpy as np
    import torch

    from imagetranslate_tpu_torch.decoding.beam import (
        beam_search,
        max_len_for,
    )

    cfg = model.cfg
    rng = np.random.RandomState(seed)
    src = torch.as_tensor(rng.randint(5, cfg.vocab_size, (B, S))).to(device)
    mask = torch.ones((B, S), dtype=torch.bool, device=device)
    langs = torch.zeros((B,), dtype=torch.int32, device=device)
    tgt_langs = torch.ones((B,), dtype=torch.int32, device=device)
    sizes = torch.full((B,), S, dtype=torch.int32, device=device)
    first = torch.full((B,), 6, dtype=torch.int32, device=device)
    L = max_len_for(S, 1.3, 5, cfg.max_position_embeddings)

    steps = 0
    step = model.decode_step

    def counted_step(*a, **kw):
        nonlocal steps
        steps += 1
        return step(*a, **kw)

    model.decode_step = counted_step
    try:
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            enc = model.encode(src, mask, langs)
            best, lengths = beam_search(
                model, enc, mask, first, tgt_langs, sizes, beam_width=K,
                max_len=L, len_penalty_ratio=0.8, pad_id=cfg.pad_id,
                eos_id=-1)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        del model.decode_step
    if best.shape != (B, L) or lengths.shape != (B,):
        raise AssertionError(f"decode shapes {tuple(best.shape)} "
                             f"{tuple(lengths.shape)}, want ({B}, {L})")
    if not (best[:, 0] == 6).all():
        raise AssertionError("decode rows must start with the first token")
    if not ((best >= 0) & (best < cfg.vocab_size)).all():
        raise AssertionError("decoded ids outside the vocab")
    if not (lengths == min(int(1.3 * S + 5), L)).all():
        raise AssertionError(f"lengths {lengths.unique().tolist()}, want "
                             "every row at its limit")
    return best, lengths, steps, seconds


def phase_decode(card):
    import torch

    from imagetranslate_tpu_torch.ops import topk_project as tkp

    device = torch.device("cuda")
    model = build_model(bert_base(32000), device)
    B, S, K = 64, 64, 4
    run_decode(model, B, S, K, device)               # warm-up
    tkp.LAUNCHES = 0
    _, lengths, steps, seconds = run_decode(model, B, S, K, device)
    launches = tkp.LAUNCHES
    if launches != steps or steps == 0:
        raise AssertionError(f"project_topk launched {launches} times in "
                             f"{steps} decode steps")
    tokens = int(lengths.sum())
    log(f"[decode] BERT-base bf16 B={B} S={S} beam={K} L=88: {steps} steps, "
        f"{launches} kernel launches, {tokens} tokens in {seconds:.3f} s = "
        f"{tokens / seconds:.1f} tok/s (encode + beam search; {card})")
    return launches, model


def _profile(run, label: str, card: str):
    """``run()`` (returns its wall seconds and a note) under torch.profiler:
    device time by kernel and by aten op, and the device's busy share of
    this same run (the union of its device intervals over the run's wall
    time, which the profiler itself lengthens)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, note = run()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in dev):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    total = sum(e.time_range.elapsed_us() for e in dev)
    log(f"[profile {label}] profiled wall {wall * 1e3:.1f} ms, {note}, "
        f"device busy {busy / 1e3:.1f} ms = {busy / (wall * 1e6):.3f} of it "
        f"(device time summed {total / 1e3:.1f} ms; {card})")
    by_kernel = {}
    for e in dev:
        n, t = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, t + e.time_range.elapsed_us())
    for name, (n, t) in sorted(by_kernel.items(), key=lambda x: -x[1][1])[:14]:
        log(f"[profile {label}] kernel {t / 1e3:9.3f} ms "
            f"{100 * t / total:5.1f} % x{n:5d}  {name[:90]}")
    ops = [a for a in prof.key_averages()
           if a.key.startswith("aten::") and a.self_device_time_total > 0]
    for a in sorted(ops, key=lambda a: -a.self_device_time_total)[:10]:
        t = a.self_device_time_total
        log(f"[profile {label}] op {t / 1e3:9.3f} ms {100 * t / total:5.1f} % "
            f"x{a.count:5d}  {a.key}")


def _profile_shapes(run, label: str, op: str):
    """One more ``run()`` under torch.profiler with input shapes recorded
    (which costs host time, so it is a run of its own): the device time of
    ``op`` split by its input shapes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        _, note = run()
    rows = [a for a in prof.key_averages(group_by_input_shape=True)
            if a.key == op and a.self_device_time_total > 0]
    total = sum(a.self_device_time_total for a in rows)
    log(f"[profile {label}] {op} by input shapes, {note}: "
        f"{total / 1e3:.3f} ms of device time in "
        f"{sum(a.count for a in rows)} calls")
    for a in sorted(rows, key=lambda a: -a.self_device_time_total)[:12]:
        t = a.self_device_time_total
        log(f"[profile {label}] {op} {t / 1e3:9.3f} ms "
            f"{100 * t / total:5.1f} % x{a.count:5d}  {a.input_shapes[:2]}")


def phase_profile(model, card):
    """One more full-width decode under torch.profiler, after three
    unprofiled ones whose walls are printed for comparison."""
    import torch

    device = torch.device("cuda")
    B, S, K = 64, 64, 4
    walls = [run_decode(model, B, S, K, device)[3] for _ in range(3)]
    log(f"[profile decode] unprofiled walls {walls} s")

    def run():
        _, _, steps, wall = run_decode(model, B, S, K, device)
        return wall, f"{steps} steps"

    _profile(run, "decode", card)


WORDS = ["alpha", "beta", "gamma", "delta", "epsi", "zeta", "eta", "theta",
         "iota", "kappa", "lambda", "mu", "nu", "xi", "omicron", "pi"]


def run_cli(workdir, device: str, make_cfg, n_lines: int = 50):
    """Tokenizer + full-width checkpoint + cli.translate.main; returns the
    output lines."""
    import numpy as np

    from imagetranslate_tpu_torch.cli.translate import main
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train.checkpoint import save_params
    from imagetranslate_tpu_torch.train.weights import random_params

    rng = np.random.RandomState(SEED)
    corpus = os.path.join(workdir, "corpus.txt")
    with open(corpus, "w") as f:
        f.write("\n".join(" ".join(WORDS[j] for j in rng.randint(
            0, len(WORDS), rng.randint(2, 9))) for _ in range(400)))
    tok = os.path.join(workdir, "tok")
    TextProcessor().train_tokenizer([corpus], 300, tok,
                                    {"<en>": 0, "<fa>": 1})
    tp = TextProcessor(tok)
    cfg = make_cfg(tp.vocab_size())
    ckpt = os.path.join(workdir, "model")
    save_params(ckpt, cfg, random_params(cfg, SEED))
    inp = os.path.join(workdir, "in.txt")
    with open(inp, "w") as f:
        f.write("\n".join(" ".join(WORDS[j] for j in rng.randint(
            0, len(WORDS), rng.randint(1, 12))) for _ in range(n_lines)))
    out = os.path.join(workdir, "out.txt")
    main(["--tok", tok, "--model", ckpt, "--input", inp, "--output", out,
          "--src", "en", "--target", "fa", "--device", device, "--verbose"])
    with open(out) as f:
        lines = f.read().splitlines()
    if len(lines) != n_lines or not all(" ||| " in ln for ln in lines):
        raise AssertionError(f"translate wrote {len(lines)} lines for "
                             f"{n_lines} inputs")
    return lines, cfg


def phase_cli():
    from imagetranslate_tpu_torch.ops import topk_project as tkp

    tkp.LAUNCHES = 0
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        lines, cfg = run_cli(workdir, "cuda", bert_base)
        seconds = time.perf_counter() - t0
    if tkp.LAUNCHES == 0:
        raise AssertionError("translate never launched project_topk")
    log(f"[cli] translate: {len(lines)} lines (vocab {cfg.vocab_size}, "
        f"hidden {cfg.hidden_size}, {cfg.enc_layers}+{cfg.dec_layers} "
        f"layers) with {tkp.LAUNCHES} kernel launches in {seconds:.1f} s, "
        f"e.g. {lines[0]!r}")


ATTN_TOL = 2.0 ** -6   # bf16 outputs: a few bf16 ulps of the largest value
DBIAS_TOL = 1e-4       # fp32 dbias: sums of ~2^-17-accurate terms
RATE = 0.1


def phase_kernel_attention():
    """Phase 6: the fused dropout attention kernels against their plain
    versions, their mask statistics, and their times."""
    import torch
    import torch.nn.functional as F

    from imagetranslate_tpu_torch.ops import train_attention as ta

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"fwd": 0.0, "bwd": 0.0}
    checked = set()   # (B, T, S, H, D, bias rows) held against the plain version

    def inputs(B, T, S, H, D, rows):
        q, k, v, g = (torch.randn(B, n, H, D, generator=gen,
                                  device="cuda").bfloat16()
                      for n in (T, S, S, T))
        bias = torch.randn(B, 1, T if rows else 1, S, generator=gen,
                           device="cuda")
        masked = torch.rand(bias.shape, generator=gen, device="cuda") < 0.2
        bias = torch.where(masked, torch.full_like(bias, -10000.0), bias)
        bias[0, :, 0, :] = -10000.0          # a row whose every key is masked
        return q, k, v, bias, g

    def case(B, T, S, H, D, rows, rate, seed=5):
        q, k, v, bias, g = inputs(B, T, S, H, D, rows)
        if not ta.fused_attention_supported(q, k, bias):
            raise AssertionError(f"gate refuses {(B, T, S, H, D)}")
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
        out = ta.fused_dropout_attention(*leaves, rate, seed)
        grads = torch.autograd.grad(out, leaves, g)
        torch.cuda.synchronize()
        want = ta.fused_dropout_attention_reference(q, k, v, bias, rate, seed)
        hand = ta.fused_dropout_attention_backward_reference(
            q, k, v, bias, g, rate, seed)
        errs = []
        for name, got, ref in zip(("out", "dq", "dk", "dv", "dbias"),
                                  (out, *grads), (want, *hand)):
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"{name}: {got.shape} {got.dtype} vs "
                                     f"{ref.shape} {ref.dtype}")
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} is not finite")
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            tol = DBIAS_TOL if name == "dbias" else ATTN_TOL
            if err > tol * scale:
                raise AssertionError(
                    f"kernel vs plain, {name} at {(B, T, S, H, D)} rows="
                    f"{rows} rate={rate}: err {err:.3g} > {tol:.3g} * "
                    f"{scale:.3g}")
            errs.append(err / scale if scale else 0.0)
            key = "fwd" if name == "out" else "bwd"
            worst[key] = max(worst[key], err)
        checked.add((B, T, S, H, D, bias.shape[2]))
        log(f"[kernel K1] B={B} T={T} S={S} H={H} D={D} bias rows="
            f"{T if rows else 1} rate={rate}: err/max out {errs[0]:.2e} dq "
            f"{errs[1]:.2e} dk {errs[2]:.2e} dv {errs[3]:.2e} dbias "
            f"{errs[4]:.2e}")

    shapes = [
        (256, 64, 64, 12, 64),    # the training shape: encoder layers
        (256, 63, 63, 12, 64),    # decoder self-attention over tgt[:, :-1]
        (256, 63, 64, 12, 64),    # decoder cross-attention
        (32, 256, 256, 12, 64),   # packed rows; four query tiles
        (16, 48, 80, 12, 64),     # cross-attention, T != S
        (3, 100, 33, 2, 32),      # ragged T and S
        (2, 7, 255, 2, 64),       # the shared-memory edge at D = 64
        (2, 130, 16, 1, 128),     # D = 128, three query tiles
        (1, 9, 352, 2, 16),       # D = 16: the longest S the gate takes
        (2, 1, 1, 1, 16),         # one query, one key
    ]
    for shape in shapes:
        for rows in (0, 1):
            for rate in (0.0, RATE):
                case(*shape, rows, rate)

    # Outside the gate the wrapper raises before any launch.
    q, k, v, bias, _ = inputs(2, 8, 257, 2, 64, 0)
    launches = ta.FWD_LAUNCHES
    for args in ((q, k, v, bias), (q.float(), k.float(), v.float(), bias)):
        try:
            ta.fused_dropout_attention(*args, RATE, 1)
        except (ValueError, TypeError):
            continue
        raise AssertionError("a shape or dtype outside the gate was launched")
    if ta.FWD_LAUNCHES != launches:
        raise AssertionError("a refused call counted as a launch")

    # The Python gate repeats the kernels' tile arithmetic: hold it against
    # the library's own answer over the (S, D) plane and at the grid's edge.
    from imagetranslate_tpu_torch.ops import _build

    lib = _build.load()
    swept = 0
    for Bg, Hg in ((2, 2), (65535, 1), (65536, 1), (1, 65536)):
        for D in (8, 16, 24, 32, 64, 96, 128, 256):
            for S in (1, 15, 64, 255, 256, 257, 272, 352, 353, 512, 513):
                qg = torch.empty((Bg, 3, Hg, D), dtype=torch.bfloat16,
                                 device="meta")
                kg = torch.empty((Bg, S, Hg, D), dtype=torch.bfloat16,
                                 device="meta")
                want = bool(lib.itt_fused_attn_supported(Bg, 3, S, Hg, D, 1))
                if ta.fused_attention_supported(qg, kg, None) != want:
                    raise AssertionError(
                        f"the Python gate and the library disagree at B={Bg} "
                        f"S={S} H={Hg} D={D}: library says {want}")
                if want and not lib.itt_fused_attn_supported(Bg, 3, S, Hg, D,
                                                             0):
                    raise AssertionError(
                        f"the forward refuses B={Bg} S={S} H={Hg} D={D}, "
                        "which the backward takes")
                swept += 1
    log(f"[kernel K1] the Python gate equals the library's at {swept} shapes")

    # The mask straight from the kernel: q = k = 0 gives uniform probs 1/S,
    # v = identity (S = D) returns them, so out > 0 is the keep-mask.
    B, T, H, n = 64, 64, 12, 64
    z = torch.zeros(B, T, H, n, device="cuda", dtype=torch.bfloat16)
    eye = torch.eye(n, device="cuda", dtype=torch.bfloat16)[
        None, :, None, :].expand(B, n, H, n).contiguous()
    nobias = torch.zeros(B, 1, 1, n, device="cuda")

    def kernel_mask(seed):
        out = ta.fused_dropout_attention(z, z, eye, nobias, RATE, seed)
        return out.permute(0, 2, 1, 3) > 0              # [B, H, T, S]

    m1, m1b, m2 = kernel_mask(11), kernel_mask(11), kernel_mask(12)
    torch.cuda.synchronize()
    count = m1.numel()
    keep = m1.float().mean().item()
    sigma = (RATE * (1 - RATE) / count) ** 0.5
    if abs(keep - (1 - RATE)) > 4 * sigma:
        raise AssertionError(f"keep rate {keep} not within 4 sigma "
                             f"({4 * sigma:.2e}) of {1 - RATE}")
    if not torch.equal(m1, m1b):
        raise AssertionError("same seed, different mask")
    if not torch.equal(m1, ta.keep_mask(RATE, 11, B, H, T, n, "cuda")):
        raise AssertionError("the kernel's mask is not the plain version's")
    differ = (m1 != m2).float().mean().item()
    if not 0.15 < differ < 0.21:                        # 2 * 0.1 * 0.9
        raise AssertionError(f"masks of two seeds differ at {differ}")
    log(f"[kernel K1] mask from the kernel: keep rate {keep:.6f} over "
        f"{count} draws (4 sigma = {4 * sigma:.2e}), same seed same mask, "
        f"equal to the plain version's, two seeds differ at {differ:.4f}")

    # Times at the training shape, cold L2, plain-kernel-kernel-plain.
    B, T, S, H, D = 256, 64, 64, 12, 64
    q, k, v, bias, g = inputs(B, T, S, H, D, 0)
    runs = {"plain": [], "kernel": [], "plain_bwd": [], "kernel_bwd": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        if name == "kernel":
            runs["kernel"].append(_time_ms(
                lambda: ta._launch_fwd(q, k, v, bias, RATE, 3)))
            runs["kernel_bwd"].append(_time_ms(
                lambda: ta._launch_bwd(q, k, v, bias, g, RATE, 3, False)))
        else:
            runs["plain"].append(_time_ms(
                lambda: ta.fused_dropout_attention_reference(
                    q, k, v, bias, RATE, 3), iters=10))
            runs["plain_bwd"].append(_time_ms(
                lambda: ta.fused_dropout_attention_backward_reference(
                    q, k, v, bias, g, RATE, 3), iters=10))
    # The library yardstick: one fused PyTorch call, never on the port's path.
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    gh = g.transpose(1, 2)
    mask = bias.to(torch.bfloat16)
    held = {}

    def sdpa():
        held["out"] = F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, dropout_p=RATE)

    lib_fwd = _time_ms(sdpa)
    lib_bwd = _time_ms(
        lambda: torch.autograd.grad(held["out"], (qh, kh, vh), gh),
        setup=sdpa)
    elems = B * H * D
    fwd_bound = bound(2 * elems * (2 * T + 2 * S) + bias.numel() * 4,
                      4.0 * B * H * T * S * D)
    # The backward reads q, k, v, g and writes dq, dk, dv (no out: the
    # softmax's row term is recomputed from dp and p); dbias is not asked for.
    bwd_bound = bound(2 * elems * (3 * T + 4 * S) + bias.numel() * 4,
                      10.0 * B * H * T * S * D)
    log(f"[kernel K1] B={B} T={T} S={S} H={H} D={D} rate={RATE}: forward "
        f"kernel {runs['kernel']} ms, plain {runs['plain']} ms, SDPA "
        f"{lib_fwd:.4f} ms, bound {fwd_bound[0]:.4f} ms; backward kernel "
        f"{runs['kernel_bwd']} ms, plain {runs['plain_bwd']} ms, SDPA "
        f"{lib_bwd:.4f} ms, bound {bwd_bound[0]:.4f} ms")

    # The packed shape (four query tiles, a per-query bias), kernels only.
    pq, pk, pv, pbias, pg = inputs(32, 256, 256, H, D, 1)
    packed = [_time_ms(lambda: ta._launch_fwd(pq, pk, pv, pbias, RATE, 3)),
              _time_ms(lambda: ta._launch_bwd(pq, pk, pv, pbias, pg, RATE, 3,
                                              False))]
    packed_bounds = [
        bound(2 * 32 * H * D * 4 * 256 + pbias.numel() * 4,
              4.0 * 32 * H * 256 * 256 * D)[0],
        bound(2 * 32 * H * D * 7 * 256 + pbias.numel() * 4,
              10.0 * 32 * H * 256 * 256 * D)[0]]
    log(f"[kernel K1] B=32 T=S=256 H={H} D={D} bias rows=256 rate={RATE}: "
        f"forward kernel {packed[0]:.4f} ms (bound {packed_bounds[0]:.4f}), "
        f"backward kernel {packed[1]:.4f} ms (bound {packed_bounds[1]:.4f})")

    def entry(key, err, bnd, lib):
        return {"max_abs_err": err, "ms": sum(runs[key]) / 2,
                "plain_ms": sum(runs["plain" + key[6:]]) / 2,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib}

    return (entry("kernel", worst["fwd"], fwd_bound, lib_fwd),
            entry("kernel_bwd", worst["bwd"], bwd_bound, lib_bwd), checked)


def train_batches(cfg, n: int, B: int, S: int, T: int, device, seed=SEED):
    """n staged batches of full rows over the whole vocabulary, ids drawn
    with a skew (id ~ V u^3) so that there is something to learn."""
    import numpy as np

    from imagetranslate_tpu_torch.data.loader import MTBatch
    from imagetranslate_tpu_torch.train.step import mt_batch_to_device

    rng = np.random.RandomState(seed)

    def ids(shape):
        return (5 + (cfg.vocab_size - 5) * rng.rand(*shape) ** 3).astype(
            np.int32)

    out = []
    for _ in range(n):
        src, dst = ids((B, S)), ids((B, T))
        ones = np.ones((B,), np.int32)
        out.append(mt_batch_to_device(MTBatch(
            src, src != cfg.pad_id, dst, dst != cfg.pad_id, 0 * ones, ones,
            S * ones, ones.astype(bool)), device))
    return out


def phase_train(card, profile: bool, checked):
    """Phase 7: MTTrainer steps at full width. ``checked``: the attention
    shapes phase 6 held against the plain version; every shape the step gives
    the kernels must be one of them."""
    import dataclasses

    import torch

    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer

    device = torch.device("cuda")
    cfg = dataclasses.replace(bert_base(32000), dropout=RATE,
                              attention_dropout=RATE)
    B, S, T, warm, timed = 256, 64, 64, 3, 12
    torch.cuda.reset_peak_memory_stats()
    trainer = MTTrainer(cfg, None, lr=5e-4, warmup=8, seed=SEED,
                        device=device)
    masters = {p.dtype for p in trainer.model.parameters()}
    if masters != {torch.float32}:
        raise AssertionError(f"master parameters are {masters}, want fp32")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    batches = train_batches(cfg, 4, B, S, T, device)
    ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
    metrics = []

    def steps(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            batch = batches[len(metrics) % len(batches)]
            trainer.state, m = trainer.mt_step(trainer.state, batch,
                                               trainer.rng)
            metrics.append(m)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # The warm-up steps also record the shapes the step gives each kernel.
    seen = {"forward": set(), "backward": set()}
    launch = {"forward": ta._launch_fwd, "backward": ta._launch_bwd}

    def recording(which):
        def wrapped(q, k, v, bias, *rest):
            seen[which].add((*q.shape[:2], k.shape[1], *q.shape[2:],
                             bias.shape[2]))
            return launch[which](q, k, v, bias, *rest)
        return wrapped

    ta._launch_fwd, ta._launch_bwd = recording("forward"), recording("backward")
    try:
        steps(warm)
    finally:
        ta._launch_fwd, ta._launch_bwd = launch["forward"], launch["backward"]
    for which, shapes in seen.items():
        if not shapes or shapes - checked:
            raise AssertionError(
                f"the train step gave the {which} kernel shapes that were "
                f"not held against the plain version: "
                f"{sorted(shapes - checked)} (seen {sorted(shapes)})")
    log(f"[train] attention shapes (B, T, S, H, D, bias rows) of a step, all "
        f"checked in phase 6: {sorted(seen['forward'])}")
    seconds = steps(timed)
    fwd, bwd = ta.FWD_LAUNCHES, ta.BWD_LAUNCHES
    n_steps = warm + timed
    per_step = cfg.enc_layers + 2 * cfg.dec_layers
    if not (fwd == bwd == per_step * n_steps):
        raise AssertionError(f"{fwd} forward and {bwd} backward launches in "
                             f"{n_steps} steps, want {per_step} per step")
    losses = [(m["sum_loss"] / m["ntokens"]).item() for m in metrics]
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"loss not finite: {losses}")
    first = sum(losses[:4]) / 4
    last = sum(losses[-4:]) / 4
    if not last < first - 0.1:
        raise AssertionError(f"loss did not fall: {losses}")
    after = trainer.model.state_dict()
    changed = sum(not torch.equal(before[k], after[k]) for k in before)
    if changed < len(before) - 2 or trainer.state.step != n_steps:
        raise AssertionError(f"only {changed} of {len(before)} parameters "
                             f"changed in {trainer.state.step} steps")
    if not all(torch.isfinite(v).all() for v in after.values()):
        raise AssertionError("a parameter is not finite after training")
    tokens = sum(int(m["ntokens"].item()) for m in metrics[warm:])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train] BERT-base fp32 masters / bf16 compute, dropout {RATE}, "
        f"B={B} S=T={S}: {timed} steps, {tokens} target tokens in "
        f"{seconds:.3f} s = {tokens / seconds:.1f} tok/s "
        f"({1e3 * seconds / timed:.1f} ms/step); loss {first:.4f} -> "
        f"{last:.4f}; {fwd} forward + {bwd} backward K1 launches "
        f"({per_step} + {per_step} per step); {changed}/{len(before)} "
        f"parameters changed; peak memory {peak:.2f} GiB ({card})")
    if profile:
        walls = [steps(1) for _ in range(3)]
        log(f"[profile train] unprofiled walls {walls} s per step")
        _profile(lambda: (steps(3), "3 steps"), "train", card)
        _profile_shapes(lambda: (steps(3), "3 steps"), "train", "aten::copy_")
    return fwd, bwd


def phase_train_cli():
    """Phase 8: corpus -> tokenizer -> binarize -> cli.train_mt -> the
    checkpoint it wrote through cli.translate and load_checkpoint."""
    import numpy as np

    from imagetranslate_tpu_torch.cli.train_mt import main as train_main
    from imagetranslate_tpu_torch.cli.translate import main as translate_main
    from imagetranslate_tpu_torch.data.binarize import write_mt
    from imagetranslate_tpu_torch.ops import topk_project as tkp
    from imagetranslate_tpu_torch.ops import train_attention as ta
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train.checkpoint import load_checkpoint

    steps = 6
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        rng = np.random.RandomState(SEED)
        lines = [" ".join(WORDS[j] for j in rng.randint(
            0, len(WORDS), rng.randint(2, 12))) for _ in range(600)]
        src, dst = (os.path.join(workdir, n) for n in ("src.txt", "dst.txt"))
        with open(src, "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(dst, "w") as f:                       # the reversed line
            f.write("\n".join(" ".join(reversed(ln.split()))
                              for ln in lines) + "\n")
        tok = os.path.join(workdir, "tok")
        TextProcessor().train_tokenizer([src], 300, tok,
                                        {"<en>": 0, "<fa>": 1})
        tp = TextProcessor(tok)
        mt = os.path.join(workdir, "train.mt")
        n = write_mt(tp, mt, src, tp.token_id("<en>"), dst,
                     tp.token_id("<fa>"))
        model = os.path.join(workdir, "model")
        ta.FWD_LAUNCHES = ta.BWD_LAUNCHES = 0
        train_main(["--tok", tok, "--model", model, "--train_mt", mt,
                    "--dec", "3", "--step", str(steps), "--lr", "0.001",
                    "--warmup", "10", "--device", "cuda"])
        fwd, bwd = ta.FWD_LAUNCHES, ta.BWD_LAUNCHES
        if not (fwd == bwd == 12 * steps):
            raise AssertionError(f"train_mt: {fwd} forward and {bwd} backward "
                                 f"launches in {steps} steps")
        latest = model + ".latest"
        params, opt_tree, meta = load_checkpoint(latest, with_opt_state=True)
        word = params["params"]["embeddings"]["word"]["embedding"]
        if (meta["step"] != steps or int(opt_tree["1"]["count"]) != steps
                or tuple(word.shape) != (tp.vocab_size(), 768)
                or str(word.dtype) != "torch.float32"):
            raise AssertionError(f"checkpoint: meta {meta}, word embedding "
                                 f"{tuple(word.shape)} {word.dtype}")
        inp, out = (os.path.join(workdir, n) for n in ("in.txt", "out.txt"))
        with open(inp, "w") as f:
            f.write("\n".join(lines[:40]) + "\n")
        tkp.LAUNCHES = 0
        translate_main(["--tok", tok, "--model", latest, "--input", inp,
                        "--output", out, "--src", "en", "--target", "fa",
                        "--device", "cuda"])
        with open(out) as f:
            hyps = f.read().splitlines()
        if len(hyps) != 40 or tkp.LAUNCHES == 0:
            raise AssertionError(f"translate wrote {len(hyps)} lines with "
                                 f"{tkp.LAUNCHES} kernel launches")
        seconds = time.perf_counter() - t0
    log(f"[train cli] {n} pairs, vocab {tp.vocab_size()}, width 768, 6+3 "
        f"layers: {steps} steps with {fwd} + {bwd} K1 launches, checkpoint "
        f"with optimizer state re-loaded (step {meta['step']}), translated "
        f"40 lines with {tkp.LAUNCHES} project_topk launches in "
        f"{seconds:.1f} s, e.g. {hyps[0]!r}")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "imagetranslate_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(imagetranslate_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the smoke test runs on an H100 only",
              file=sys.stderr)
        return 1
    profile = "--profile" in sys.argv[1:]
    card = phase_device()
    phase_build()
    topk = phase_kernel()
    launches, model = phase_decode(card)
    if profile:
        phase_profile(model, card)
    del model
    torch.cuda.empty_cache()
    phase_cli()
    attn_fwd, attn_bwd, checked = phase_kernel_attention()
    fwd_launches, bwd_launches = phase_train(card, profile, checked)
    torch.cuda.empty_cache()
    phase_train_cli()
    attn_src = "imagetranslate_tpu_torch/csrc/train_attention.cu"
    print(card)
    print(json.dumps({"kernels": [
        {"name": "project_topk", "route": "cuda",
         "source": "imagetranslate_tpu_torch/csrc/topk_project.cu",
         "replaces": "imagetranslate_tpu/ops/topk_project.py:206",
         "launches": launches, **topk},
        {"name": "fused_dropout_attention_fwd", "route": "cuda",
         "source": attn_src,
         "replaces": "imagetranslate_tpu/ops/train_attention.py:242",
         "launches": fwd_launches, **attn_fwd},
        {"name": "fused_dropout_attention_bwd", "route": "cuda",
         "source": attn_src,
         "replaces": "imagetranslate_tpu/ops/train_attention.py:256",
         "launches": bwd_launches, **attn_bwd},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
