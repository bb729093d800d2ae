"""The ``translate`` traffic kind: bulk beam-search translation as
``cli.translate`` runs it.

Sources (``textgen``, a fixed multiset of lengths, ids from the seed) are
binarized as the CLI binarizes its input lines (the source language token,
the words, the separator; the target language token as the first output
token), sorted by length as a bulk job's input is, and batched by the
program's ``MTBatcher`` at the mix's ``--batch`` and ``--capacity``; a pass
is a sample of those batches at even strides (``corpus``). The
window drives ``cli/translate.py::translate_batches`` (its prefetch thread,
``encode``, ``beam_search`` and its writer) over the batches, whole passes of
the corpus in a fixed order until one ends after ``--seconds``, so every
run decodes the same batches. The separator lies outside
the vocabulary, so every row decodes to its own limit,
floor(max_len_a * source + max_len_b).
"""

from __future__ import annotations

import contextlib
import sys
import time
import types

import numpy as np

import flops
import harness
import probes
import served
import textgen
from vocab import StandInVocab


def corpus(mix: dict, config: dict, seed: int):
    """The pass: ``pass_batches`` of the batches that ``MTBatcher`` makes of
    a length-sorted corpus of ``corpus_sentences``, taken at even strides
    through it, so that the pass holds full batches of each length in the
    proportion a bulk job has them (the rare long buckets fall between the
    strides, as they are rare in such a job)."""
    from imagetranslate_tpu_torch.data.loader import MTBatcher

    lens = np.sort(textgen.lengths(mix["corpus_sentences"], mix["length"]))
    rng = np.random.default_rng(seed)
    src = textgen.sentences(lens, textgen.LANG_TOKENS[0],
                            config["vocab_size"], rng)
    ex = [(s, [textgen.LANG_TOKENS[1]], 0, 1) for s in src]
    batches = MTBatcher(ex, pad_id=0, max_batch=mix["batch"],
                        capacity_mb=mix["capacity"], max_seq_len=10000,
                        bucket_step=mix["bucket_step"]).batches
    stride = len(batches) / mix["pass_batches"]
    return [batches[int((i + 0.5) * stride)]
            for i in range(mix["pass_batches"])]


def expected_tokens(size: int, sb: int, opt, max_positions: int) -> int:
    """Tokens a row of ``size`` source tokens answers with when no row ends
    early: its limit (fp32 arithmetic, as the decoder computes it), less
    the first token, which is not written."""
    L = min(int(opt.max_len_a * sb + opt.max_len_b), max_positions)
    L = min(-(-L // 16) * 16, max_positions)
    f32 = np.float32
    limit = int(np.floor(f32(opt.max_len_a) * f32(size) + f32(opt.max_len_b)))
    return min(limit, L) - 1


class Session:
    """The serving model from the seed's weights and the mix's batches."""

    def __init__(self, cell, seed: int, device):
        import torch

        from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
        from weights import specs_of

        self.cell, self.seed, self.device = cell, seed, device
        config, mix = cell.config, cell.traffic
        self.cfg = harness.seq2seq_config(config)
        self.opt = types.SimpleNamespace(
            beam_width=mix["beam"], max_len_a=mix["max_len_a"],
            max_len_b=mix["max_len_b"], len_penalty_ratio=mix["len_penalty"],
            verbose=False, clean_ties=False)
        self.tp = StandInVocab(config["vocab_size"], sep=-1)
        self.batches = corpus(mix, config, seed)
        self.order = textgen.interleaved(len(self.batches))
        with torch.device("meta"):
            self.specs = specs_of(Seq2Seq(self.cfg))
        self.model = Seq2Seq(self.cfg, device=device)
        self.model.load_state_dict(self.weights())
        self.model.eval()

    def weights(self):
        """The served weights, made from the seed."""
        from weights import make_weights

        return make_weights(self.specs, self.seed, self.device,
                            self.cell.config["initializer_range"])

    def decode(self, stream, writer):
        from imagetranslate_tpu_torch.cli.translate import translate_batches

        with contextlib.redirect_stdout(sys.stderr):
            translate_batches(self.model, self.cfg, self.tp, stream, self.opt,
                              writer)

    def warm(self):
        """One batch of every shape the window decodes, each row's source
        length taken as 1: the same tensors and cache, six decode steps."""
        import dataclasses

        seen, warm = set(), []
        for i in self.order:
            b = self.batches[i]
            if b.src.shape not in seen:
                seen.add(b.src.shape)
                warm.append(dataclasses.replace(
                    b, src_sizes=np.ones_like(b.src_sizes)))
        self.decode(served.Stream(warm, range(len(warm))), served.Kept())
        harness.sync(self.device)

    def answers(self, stream, out):
        """The answers as written (a chunk a batch, in the order handed
        out): [(batch, row, tokens, call)], ``call`` the index of the
        batch's ``beam_search`` call in the stream, the rows attempted,
        those whose answer never came or has another length than the row's
        limit, and the model FLOPs of the answers."""
        config, opt, batches = self.cell.config, self.opt, self.batches
        answers, failed, attempted, work = [], 0, 0, 0.0
        for n, (j, chunk) in enumerate(zip(stream.given, out.chunks)):
            b = batches[j]
            lines = chunk.rstrip("\n").split("\n")
            n_real = int(b.row_mask.sum())
            attempted += n_real
            for r in range(n_real):
                toks = ([int(t) for t in lines[r].split()]
                        if r < len(lines) else [])
                size = int(b.src_sizes[r])
                if len(toks) != expected_tokens(
                        size, b.src.shape[1], opt,
                        self.cfg.max_position_embeddings):
                    failed += 1
                answers.append((j, r, toks, n))
                work += served.decode_flops(
                    config, opt.beam_width, size, len(toks),
                    flops.encode_flops(config, [size]))
        attempted += sum(int(batches[j].row_mask.sum())
                         for j in stream.given[len(out.chunks):])
        failed += attempted - len(answers)
        return answers, attempted, failed, work

    def kept_calls(self):
        """The first pass's calls whose beam trail the check reads: the
        longest batch's and ``trail_batches`` drawn from the seed."""
        return served.kept_calls(self.order, len(self.batches) - 1,
                                 self.cell.traffic["trail_batches"],
                                 self.seed)

    def close(self):
        del self.model
        harness.free_memory(self.device)


def run(cell, seed: int, seconds: float, trace: bool, device):
    mix = cell.traffic
    s = Session(cell, seed, device)
    harness.phase(f"{len(s.batches)} batches, the model built")
    s.warm()
    harness.phase("warm-up")

    harness.reset_peak(device)
    stream, out = served.Stream(s.batches, s.order), served.Kept()
    counter = probes.CallCounter(s.model, "decode_step")
    trail = probes.BeamTrail(s.model, s.kept_calls())
    with harness.quiet():
        window_wall = time.time()
        t0 = time.perf_counter()
        stream.deadline = t0 + seconds
        with counter, trail:
            s.decode(stream, out)
        harness.sync(device)
        window_s = time.perf_counter() - t0
    dev = harness.device_record(device)
    answers, attempted, failed, work = s.answers(stream, out)
    tokens = sum(len(a[2]) for a in answers)

    result = {"attempted": attempted, "failed": failed, "device": dev}
    metrics, readings = {}, {}
    if not trace:
        metrics["decode_tok_s"] = {"value": tokens / window_s,
                                   "unit": "tokens/s"}
        metrics["peak_mem_gib"] = {"value": dev["memory_peak_bytes"] / 2**30,
                                   "unit": "GiB"}
    else:
        readings["decode"] = {"window_s": window_s, "steps": counter.calls,
                              "flops": work}
        if device.type == "cuda":
            from imagetranslate_tpu_torch.decoding import beam

            shapes = probes.KernelShapes()
            spans = probes.Spans([
                (s.model, "encode", "model.encode"),
                (s.model, "decode_step", "model.decode_step"),
                (beam, "beam_search", "decoding.beam_search"),
                (beam, "reorder_caches", "decoding.reorder_caches")])

            def traced_pass():
                s.decode(served.Stream(s.batches, s.order), served.Kept())

            def label_batches():
                s.decode(served.Stream(s.batches, s.order,
                                       limit=mix["label_batches"]),
                         served.Kept())

            tr = harness.trace_window(traced_pass, label_batches, device,
                                      shapes, spans)
            readings["trace"] = tr
            readings["kernels"] = shapes.readings(tr)
            dev["busy_s"] = tr.busy_s()
            dev["window_s"] = tr.window_s
            result["breakdown"] = tr.breakdown()
    result["window_wall"] = window_wall
    result["window_s"] = window_s

    rows = sampled(cell, s, answers, trail)
    s.close()
    t = time.perf_counter()
    numbers, _ = check(cell, s, rows)
    harness.log(f"the reference took {time.perf_counter() - t:.1f} s")
    numbers["wrong_lengths"] = float(failed)
    return result, metrics, readings, numbers


def sampled(cell, s: Session, answers, trail):
    """A sample of the answers of the calls ``trail`` kept (drawn from the
    seed, the longest among them): (source, first token + served tokens,
    the program's score and logsumexp path), read off the card before the
    program's state is freed."""
    kept = [a for a in answers if a[3] in trail.trails]
    pick = served.sample_rows(len(kept), [len(a[2]) for a in kept],
                              cell.traffic["check_rows"], s.seed)
    first = textgen.LANG_TOKENS[1]
    rows = []
    for n in sorted({kept[i][3] for i in pick}):
        mine = [kept[i] for i in pick if kept[i][3] == n]
        paths = served.trail_paths(trail.trails[n], [a[1] for a in mine],
                                   [len(a[2]) for a in mine])
        for (j, r, toks, _), path in zip(mine, paths):
            b = s.batches[j]
            rows.append((b.src[r, :int(b.src_sizes[r])], [first] + toks,
                         path))
    trail.trails.clear()
    return rows


def check(cell, s: Session, rows, control: bool = False):
    """The sampled answers against the fp32 reference
    (``served.check_rows``); with ``control`` also the control's numbers
    (the reference in fp8 in the program's place)."""
    import torch

    from reference.model import Seq2SeqRef
    from reference.precision import FP8, FP32, set_fp32
    set_fp32()
    device, config = s.device, cell.config
    W = {k: v.float() for k, v in s.weights().items()}

    def logits_in(prec):
        ref = Seq2SeqRef(W, config, prec)

        @torch.no_grad()
        def logits(part):
            from reference.decode import teacher_forced_logits

            S = max(len(row[0]) for row in part)
            src = torch.zeros((len(part), S), dtype=torch.long,
                              device=device)
            keep = torch.zeros((len(part), S), dtype=torch.bool,
                               device=device)
            for r, (x, _, _) in enumerate(part):
                src[r, :len(x)] = torch.as_tensor(np.asarray(x, np.int64))
                keep[r, :len(x)] = True
            pos = torch.arange(S, device=device)[None].expand(len(part), S)
            enc = ref.encode(src, pos, torch.zeros_like(src),
                             keep[:, None, None, :])
            return teacher_forced_logits(ref, enc, keep,
                                         [q for _, q, _ in part],
                                         [1] * len(part), device)
        return logits

    return served.check_rows(logits_in(FP32), rows, s.opt.beam_width,
                             s.opt.len_penalty_ratio, s.tp.pad_token_id(),
                             logits_in(FP8) if control else None)


def control(cell, seed: int, device, faults: bool) -> dict:
    """The check's readings over a short stream at the cell's load (the
    first ``control_batches`` batches of the window's order and the longest
    batch): the program's numbers and, with ``faults``, the control's."""
    s = Session(cell, seed, device)
    picked = s.order[:cell.traffic["control_batches"]]
    picked += [i for i in [len(s.batches) - 1] if i not in picked]
    stream, out = served.Stream(s.batches, picked), served.Kept()
    trail = probes.BeamTrail(s.model, range(len(picked)))
    with trail:
        s.decode(stream, out)
    answers, _, failed, _ = s.answers(stream, out)
    rows = sampled(cell, s, answers, trail)
    s.close()
    prog, lower = check(cell, s, rows, control=faults)
    res = {"program": dict(prog, wrong_lengths=float(failed))}
    if faults:
        res["control_fp8"] = lower
    return res
