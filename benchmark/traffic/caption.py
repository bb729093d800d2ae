"""The ``caption`` traffic kind: bulk image captioning as ``cli.caption``
runs it.

Batches of uint8 images (made on the card from the seed in set-up, a pool of
``pool_batches`` batches, then held on the host as the CLI's image pool
hands them over) in ``ImageFolderBatcher``'s layout go through
``cli/caption.py::caption_batches``: its prefetch thread stages each batch
onto the card while the previous one decodes, ``encode_images`` runs the
ResNet grid, ``beam_search`` decodes, the writer gets one line an image. The
separator lies outside the vocabulary, so every caption runs to
``max_len``. The window hands out the pool's batches in turn, whole passes
until one ends after ``--seconds``.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np

import flops
import harness
import probes
import served
import textgen
from vocab import StandInVocab


def image_pool(mix: dict, config: dict, seed: int, device):
    """``pool_batches`` batch dicts of ``batch`` images, drawn on the card
    from the seed and copied to the host."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    S, B = config["img_size"], mix["batch"]
    out = []
    for j in range(mix["pool_batches"]):
        images = torch.randint(0, 256, (B, S, S, 3), generator=gen,
                               device=device, dtype=torch.uint8).cpu().numpy()
        out.append({"paths": [f"{j}/{i}" for i in range(B)],
                    "images": images,
                    "first_tokens": np.full((B,), textgen.LANG_TOKENS[1],
                                            np.int32),
                    "tgt_langs": np.full((B,), 1, np.int32)})
    return out


class Session:
    """The captioner from the seed's weights and the pool of images."""

    def __init__(self, cell, seed: int, device):
        import torch

        from imagetranslate_tpu_torch.models.captioning import ImageSeq2Seq
        from weights import specs_of

        self.cell, self.seed, self.device = cell, seed, device
        config, mix = cell.config, cell.traffic
        self.cfg = harness.seq2seq_config(config)
        self.tp = StandInVocab(config["vocab_size"], sep=-1)
        self.pool = image_pool(mix, config, seed, device)
        self.order = list(range(len(self.pool)))
        self.L = min(mix["max_len"], self.cfg.max_position_embeddings)
        with torch.device("meta"):
            self.specs = specs_of(ImageSeq2Seq(self.cfg))
        self.model = ImageSeq2Seq(self.cfg, device=device)
        self.model.load_state_dict(self.weights())
        self.model.eval()

    def weights(self):
        """The served weights, made from the seed."""
        from weights import make_weights

        return make_weights(self.specs, self.seed, self.device,
                            self.cell.config["initializer_range"])

    def decode(self, stream, writer):
        from imagetranslate_tpu_torch.cli.caption import caption_batches

        mix = self.cell.traffic
        with contextlib.redirect_stdout(sys.stderr):
            caption_batches(self.model, self.tp, stream, writer,
                            beam_width=mix["beam"], max_len=mix["max_len"],
                            len_penalty_ratio=mix["len_penalty"])

    def answers(self, stream, out):
        """[(pool batch, row, tokens, call)] as written, ``call`` the index
        of the batch's ``beam_search`` call in the stream (every batch
        writes ``batch`` lines); the images attempted, those whose caption
        never came or is not ``max_len - 1`` long."""
        answers, B = [], self.cell.traffic["batch"]
        for k, line in enumerate(out.lines()):
            path, _, text = line.partition("\t")
            j, i = (int(x) for x in path.split("/"))
            answers.append((j, i, [int(t) for t in text.split()], k // B))
        attempted = len(stream.given) * self.cell.traffic["batch"]
        failed = attempted - len(answers) + sum(
            1 for a in answers if len(a[2]) != self.L - 1)
        return answers, attempted, failed

    def kept_calls(self):
        """The first pass's calls whose beam trail the check reads:
        ``trail_batches`` drawn from the seed (every caption has the same
        length)."""
        return served.kept_calls(self.order, None,
                                 self.cell.traffic["trail_batches"],
                                 self.seed)

    def close(self):
        del self.model
        harness.free_memory(self.device)


def run(cell, seed: int, seconds: float, trace: bool, device):
    config, mix = cell.config, cell.traffic
    s = Session(cell, seed, device)
    harness.phase("the image pool, the model built")
    s.decode(served.Stream(s.pool, s.order[:1]), served.Kept())   # set-up
    harness.sync(device)
    harness.phase("warm-up")

    harness.reset_peak(device)
    stream, out = served.Stream(s.pool, s.order), served.Kept()
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
    answers, attempted, failed = s.answers(stream, out)
    tokens = sum(len(a[2]) for a in answers)
    grid = (config["img_size"] // 32) ** 2
    per_image = served.decode_flops(
        config, mix["beam"], grid, s.L - 1,
        flops.resnet_flops(img=config["img_size"],
                           embed_dim=config["hidden_size"]))

    result = {"attempted": attempted, "failed": failed, "device": dev}
    metrics, readings = {}, {}
    if not trace:
        metrics["decode_tok_s"] = {"value": tokens / window_s,
                                   "unit": "tokens/s"}
        metrics["peak_mem_gib"] = {"value": dev["memory_peak_bytes"] / 2**30,
                                   "unit": "GiB"}
    else:
        readings["decode"] = {"window_s": window_s, "steps": counter.calls,
                              "flops": per_image * len(answers)}
        if device.type == "cuda":
            from imagetranslate_tpu_torch.decoding import beam

            shapes = probes.KernelShapes()
            spans = probes.Spans([
                (s.model, "encode_images", "model.encode_images"),
                (s.model, "decode_step", "model.decode_step"),
                (beam, "beam_search", "decoding.beam_search"),
                (beam, "reorder_caches", "decoding.reorder_caches")])

            def traced_pass():
                s.decode(served.Stream(s.pool, s.order), served.Kept())

            def label_batches():
                s.decode(served.Stream(s.pool, s.order,
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
    """A sample of the captions of the calls ``trail`` kept (drawn from the
    seed): ((pool batch, row), first token + served tokens, the program's
    score and logsumexp path), read off the card before the program's
    state is freed."""
    kept = [a for a in answers if a[3] in trail.trails]
    pick = served.sample_rows(len(kept), [len(a[2]) for a in kept],
                              cell.traffic["check_rows"], s.seed)
    first = textgen.LANG_TOKENS[1]
    rows = []
    for n in sorted({kept[i][3] for i in pick}):
        mine = [kept[i] for i in pick if kept[i][3] == n]
        paths = served.trail_paths(trail.trails[n], [a[1] for a in mine],
                                   [len(a[2]) for a in mine])
        for (j, i, toks, _), path in zip(mine, paths):
            rows.append(((j, i), [first] + toks, path))
    trail.trails.clear()
    return rows


def check(cell, s: Session, rows, control: bool = False):
    """The sampled captions against the fp32 reference (the ResNet grid
    and the decoder, ``served.check_rows``); with ``control`` also the
    control's numbers (the reference in fp8 in the program's place)."""
    import torch

    from reference.model import CoreView
    from reference.precision import FP8, FP32, set_fp32
    from reference.resnet import resnet_grid
    set_fp32()
    device = s.device
    W = {k: v.float() for k, v in s.weights().items()}

    def logits_in(prec):
        ref = CoreView(W, cell.config, prec)

        @torch.no_grad()
        def logits(part):
            from reference.decode import teacher_forced_logits

            images = torch.as_tensor(np.stack(
                [s.pool[j]["images"][i] for (j, i), _, _ in part])).to(
                    device)
            enc = resnet_grid(W, images, prec=prec)
            keep = torch.ones(enc.shape[:2], dtype=torch.bool, device=device)
            return teacher_forced_logits(ref, enc, keep,
                                         [q for _, q, _ in part],
                                         [1] * len(part), device)
        return logits

    mix = cell.traffic
    return served.check_rows(logits_in(FP32), rows, mix["beam"],
                             mix["len_penalty"], s.tp.pad_token_id(),
                             logits_in(FP8) if control else None)


def control(cell, seed: int, device, faults: bool) -> dict:
    """The check's readings over one batch at the cell's load: the
    program's numbers and, with ``faults``, the control's."""
    s = Session(cell, seed, device)
    stream, out = served.Stream(s.pool, s.order[:1]), served.Kept()
    trail = probes.BeamTrail(s.model, [0])
    with trail:
        s.decode(stream, out)
    answers, _, failed = s.answers(stream, out)
    rows = sampled(cell, s, answers, trail)
    s.close()
    prog, lower = check(cell, s, rows, control=faults)
    res = {"program": dict(prog, wrong_lengths=float(failed))}
    if faults:
        res["control_fp8"] = lower
    return res
