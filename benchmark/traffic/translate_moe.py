"""The ``translate_moe`` traffic kind: ``translate``'s bulk beam-search
translation (``traffic/translate.py``: its session, warm-up, answers and
sampled beam trails, through ``cli/translate.py::translate_batches``) for an
NLLB-MoE-style configuration, checked against ``reference/nllb_moe.py``.

What differs from ``translate``:

- the program must have the configuration's layout (``require_layout``): a
  program whose ``Seq2SeqConfig`` lacks one of the file's fields exits with
  5 before it builds anything, rather than build another model;
- the weights (about 9 B parameters) are drawn into the model's own tensors
  a slice at a time (``fill``), each entry by its name's rule
  (``weights._rule``, and for an MoE bank: normal experts and router, zero
  expert biases, a unit ``ln``), so that neither the program nor the
  reference holds a second copy; the reference's are the served bf16 values
  in fp32, drawn the same way;
- the batches pad with the configuration's ``pad_id`` (NLLB's 1), and the
  stand-in vocabulary reads the same pad;
- the routers are fitted to the traffic (``fit_routers``): a random
  model's decoder rows at one step share a position and mostly a token, so
  a router drawn at random sends nearly all of them to a few experts, where
  a trained router, held to balance by its load-balancing loss, spreads
  them; each router is the seed's draw, made blind to what the tokens of a
  bank's call share and whitened by how they differ (``fitted``), measured
  over a decode of the pass before the window;
- the model FLOPs (``mfu.decode``) count the dense layers, only the routed
  choices' expert products and the router, and the head over the
  vocabulary slice (``decode_flops``);
- ``correct`` adds ``dropped_choices``, counted after the window on the
  first tokens each MoE bank routed in it (``dropped``): the choices whose
  share of the bank's output is missing, against a loop over the experts;
  0 exactly;
- the reference replays the program's routing (``RouteTrail`` keeps the
  program's choices in the checked calls; ``reference/nllb_moe.py`` says
  why): the gaps then measure the computation, and ``route_excess`` the
  routing, by how much an expert the program left out beats one it took;
  the control replays its own fp8 routing alike, and a second fault, the
  program with its router in bf16 (``bf16_router``), is read as the
  program is;
- ``--trace 1`` adds ``moe_roofline`` (``kernels/moe.py``) and
  ``moe_load.decode``: the program's counters ``moe.max_load`` and
  ``moe.choices`` read while the label pass runs with the program's tracer
  on (``readings["moe"]``).
"""

from __future__ import annotations

import dataclasses
import os
import time
import types

import numpy as np

import harness
import probes
import served
import textgen
from vocab import StandInVocab

HERE = os.path.dirname(os.path.abspath(__file__))
translate = harness.load_module(os.path.join(HERE, "translate.py"),
                                "bench_kind_translate")

# The configuration file's keys that are the benchmark's, not the program's.
OWN_KEYS = ("model", "source", "published", "reduced_from", "deployment",
            "deployment_cards", "assumed", "train")
CHUNK = 1 << 26          # elements a draw: 256 MiB of fp32
# ``fitted``: the ridge added to the tokens' scatter before whitening, in
# units of its mean eigenvalue, which keeps the directions in which they
# hardly differ (bf16 rounding among them) from deciding the route; and
# the share of the scatter of the calls' means the router is blind to.
RIDGE = 10.0
SHARE = 0.99


def require_layout(config: dict) -> None:
    """Exit with 5 where the program's ``Seq2SeqConfig`` lacks a field of
    the configuration (a program from before the layout's fields)."""
    from imagetranslate_tpu_torch.models.config import Seq2SeqConfig

    fields = {f.name for f in dataclasses.fields(Seq2SeqConfig)}
    missing = sorted(k for k in config if k not in fields
                     and k not in OWN_KEYS)
    if missing:
        harness.log(f"the program's Seq2SeqConfig has no {missing}: it "
                    "cannot build this configuration")
        raise SystemExit(5)


class NllbVocab(StandInVocab):
    """The stand-in vocabulary with the configuration's pad id."""

    def __init__(self, vocab_size: int, pad: int, sep: int = -1):
        super().__init__(vocab_size, sep=sep)
        self._pad = pad

    def pad_token_id(self) -> int:
        return self._pad


def rule(name: str, shape, std: float):
    """An entry's initializer: an MoE bank's by its leaf, the rest as
    ``weights._rule``."""
    from weights import _rule

    leaf = name.rsplit(".", 1)[-1]
    if ".moe." in name:
        if leaf in ("wi", "wo"):
            return "normal", std
        if leaf in ("bi", "bo"):
            return "const", 0.0
        if ".moe.ln." in name:
            return "const", 1.0 if leaf == "weight" else 0.0
    return _rule(name, shape, std)


def fill(specs, seed: int, device, std: float, put) -> None:
    """Draws every entry of ``specs`` in order, a slice of rows at a time
    from one ``torch.Generator`` on ``device`` seeded with ``seed``, and
    hands each slice to ``put(name, rows, tensor)`` in the entry's dtype:
    the same seed and specs give the same values."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(seed))
    for name, shape, dtype in specs:
        kind, arg = rule(name, shape, std)
        if kind != "normal":
            put(name, slice(None), torch.full(shape, arg, dtype=torch.float32,
                                              device=device).to(dtype))
            continue
        per_row = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        step = max(1, CHUNK // per_row)
        for lo in range(0, shape[0], step):
            n = min(step, shape[0] - lo)
            t = torch.randn((n,) + tuple(shape[1:]), generator=gen,
                            device=device) * arg
            put(name, slice(lo, lo + n), t.to(dtype))


def corpus(mix: dict, config: dict, seed: int):
    """``translate.corpus`` with the configuration's pad id."""
    from imagetranslate_tpu_torch.data.loader import MTBatcher

    lens = np.sort(textgen.lengths(mix["corpus_sentences"], mix["length"]))
    rng = np.random.default_rng(seed)
    src = textgen.sentences(lens, textgen.LANG_TOKENS[0],
                            config["vocab_size"], rng)
    ex = [(s, [textgen.LANG_TOKENS[1]], 0, 1) for s in src]
    batches = MTBatcher(ex, pad_id=config["pad_id"], max_batch=mix["batch"],
                        capacity_mb=mix["capacity"], max_seq_len=10000,
                        bucket_step=mix["bucket_step"]).batches
    stride = len(batches) / mix["pass_batches"]
    return [batches[int((i + 0.5) * stride)]
            for i in range(mix["pass_batches"])]


# ---------------- model FLOPs ----------------

def _moe_layers(config: dict, n: int) -> int:
    return sum(1 for i in range(n) if config["moe_experts"]
               and (i + 1) % config["moe_every"] == 0)


def ffn_flops(config: dict, n_layers: int) -> float:
    """FLOPs a token of the FFNs of a stack of ``n_layers``: a dense layer's
    two products, an MoE layer's router and its k routed choices'."""
    E, F = config["hidden_size"], config["intermediate_size"]
    moe = _moe_layers(config, n_layers)
    return ((n_layers - moe) * 4.0 * E * F
            + moe * (config["moe_top_k"] * 4.0 * E * F
                     + 2.0 * E * config["moe_experts"]))


def encode_flops(config: dict, src_len: int) -> float:
    E, L = config["hidden_size"], config["enc_layers"]
    return src_len * (L * (8.0 * E * E + 4.0 * E * src_len)
                      + ffn_flops(config, L))


def decode_flops(config: dict, beam: int, src_len: int, out_len: int
                 ) -> float:
    """One answered row: its encode, the cross-attention's K/V once, and
    ``beam`` rows of every step that served one of its ``out_len`` tokens
    (live positions 1 .. n): each decoder layer's self-attention Q, K, V, O,
    the cross-attention's Q and O, attention over the live positions and
    the source, the FFNs, and the head over the vocabulary slice."""
    E, L, V = config["hidden_size"], config["dec_layers"], config["vocab_size"]
    n = out_len
    fixed = L * (12.0 * E * E + 4.0 * E * src_len) + ffn_flops(config, L) \
        + 2.0 * V * E
    live = L * 4.0 * E
    return (encode_flops(config, src_len) + L * 4.0 * E * E * src_len
            + beam * (fixed * n + live * n * (n + 1) / 2))


# ---------------- the session ----------------

class Session(translate.Session):
    """``translate.Session`` for this layout: the model built on the card
    and filled in place (``fill``)."""

    def __init__(self, cell, seed: int, device):
        import torch

        from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
        from weights import specs_of

        self.cell, self.seed, self.device = cell, seed, device
        config, mix = cell.config, cell.traffic
        require_layout(config)
        self.cfg = harness.seq2seq_config(config)
        self.opt = types.SimpleNamespace(
            beam_width=mix["beam"], max_len_a=mix["max_len_a"],
            max_len_b=mix["max_len_b"], len_penalty_ratio=mix["len_penalty"],
            verbose=False, clean_ties=False)
        self.tp = NllbVocab(config["vocab_size"], config["pad_id"])
        self.batches = corpus(mix, config, seed)
        self.order = textgen.interleaved(len(self.batches))
        with torch.device("meta"):
            self.specs = specs_of(Seq2Seq(self.cfg))
        self.model = Seq2Seq(self.cfg, device=device)
        own = self.model.state_dict()

        @torch.no_grad()
        def put(name, rows, t):
            own[name][rows].copy_(t)

        fill(self.specs, seed, device, config["initializer_range"], put)
        self.model.eval()
        self.routers = fit_routers(self, config["initializer_range"])

    def weights(self):
        """The served weights in fp32 (the reference's), drawn as ``fill``
        draws them, with the fitted routers."""
        import torch

        W = {name: torch.empty(shape, dtype=torch.float32,
                               device=self.device)
             for name, shape, _ in self.specs}

        def put(name, rows, t):
            W[name][rows] = t.to(torch.float32)

        fill(self.specs, self.seed, self.device,
             self.cell.config["initializer_range"], put)
        for name, w in self.routers.items():
            W[name] = w.to(self.device)
        return W

    def answers(self, stream, out):
        answers, attempted, failed, _ = super().answers(stream, out)
        config, beam = self.cell.config, self.opt.beam_width
        work = sum(decode_flops(config, beam,
                                int(self.batches[j].src_sizes[r]), len(toks))
                   for j, r, toks, _ in answers)
        return answers, attempted, failed, work


def fit_routers(s: "Session", std: float) -> dict:
    """Fits each MoE bank's router to the traffic, in place, and returns
    them by ``state_dict`` name (fp32, on the host). A decode of the pass
    (``s.order``) gathers, for the tokens each bank routes, each call's
    count and sum and the second moment (``fitted`` makes the router)."""
    import torch

    from imagetranslate_tpu_torch.models import moe

    banks = {m: name for name, m in s.model.named_modules()
             if isinstance(m, moe.MoEFeedForward)}
    if not banks:
        return {}
    H = s.cfg.hidden_size
    stats = {m: [[], [], torch.zeros(H, H, dtype=torch.float64,
                                     device=s.device)] for m in banks}
    route = moe.MoEFeedForward.route_dropless

    def seen(bank, tokens):
        x = tokens.to(torch.float64)
        counts, sums, second = stats[bank]
        counts.append(x.shape[0])
        sums.append(x.sum(0))
        second += x.t() @ x
        return route(bank, tokens)

    moe.MoEFeedForward.route_dropless = seen
    try:
        s.decode(served.Stream(s.batches, s.order), served.Kept())
    finally:
        moe.MoEFeedForward.route_dropless = route
    out = {}
    with torch.no_grad():
        for bank, name in banks.items():
            counts, sums, second = stats[bank]
            counts = torch.tensor(counts, dtype=torch.float64,
                                  device=s.device)
            W = fitted(bank.router.weight, counts, torch.stack(sums),
                       second / counts.sum(), std)
            bank.router.weight.copy_(W)
            out[name + ".router.weight"] = W.to(torch.float32).cpu()
    return out


def fitted(weight, counts, sums, second, std: float):
    """A router fitted to the tokens of a bank's calls, from the seed's
    draw ``weight`` [E, H], each call's token count ``counts`` [C] and sum
    ``sums`` [C, H], and the tokens' second moment ``second`` [H, H] (fp64),
    in ``weight``'s dtype. The calls' means m_c differ from the mean mu by
    what a call's tokens share (a decode step's: its position, its rows'
    few tokens); the router is made blind to mu and to the directions that
    hold ``SHARE`` of the scatter of the m_c, and whitened by the tokens'
    scatter about their call's mean, with a ridge of ``RIDGE`` times its
    mean eigenvalue; then scaled so that the tokens' router logits spread
    as a normal(``std``) router's do over LayerNorm'd input (std sqrt(H)).
    A token's route is so decided by how it differs from the other tokens
    of its call, as a trained router's load-balancing loss spreads the
    tokens of a batch."""
    import torch

    H = weight.shape[1]
    n = counts.sum()
    means = sums / counts[:, None]
    mu = sums.sum(0) / n
    within = second - sums.t() @ means / n
    d = means - mu
    between = (d * counts[:, None]).t() @ d / n
    eb, Vb = torch.linalg.eigh(between)
    eb, Vb = eb.flip(0).clamp(min=0.0), Vb.flip(1)
    r = (min(int((torch.cumsum(eb, 0) < SHARE * eb.sum()).sum()) + 1,
             H // 2) if float(eb.sum()) > 0 else 0)
    blind = torch.linalg.qr(torch.cat([Vb[:, :r], mu[:, None]], 1)).Q
    Q = torch.eye(H, dtype=torch.float64, device=mu.device) \
        - blind @ blind.t()
    ev, V = torch.linalg.eigh(Q @ within @ Q)
    ev = ev.clamp(min=0.0)
    ridge = RIDGE * ev.sum() / (H - blind.shape[1])
    W = weight.to(torch.float64) @ ((V * (ev + ridge).rsqrt()) @ V.t() @ Q)
    cov = second - torch.outer(mu, mu)
    spread = torch.einsum("eh,hg,eg->", W, cov, W) / W.shape[0]
    return (W * (std * H ** 0.5 / spread.sqrt())).to(weight.dtype)


def dropped(probes: dict) -> int:
    """Of the choices the program's routing makes for ``probes`` (bank ->
    tokens [T, H] it routed), those whose share of the bank's output is
    missing: the output lies nearer the loop over the experts' sum without
    the choice than with it."""
    import torch

    from imagetranslate_tpu_torch.models import moe

    n = 0
    with torch.no_grad():
        for bank, tokens in probes.items():
            cfg = bank.cfg
            dtype, act = cfg.compute_dtype, moe.activation(cfg)
            got = bank._dropless(tokens).to(torch.float32)
            idxs, gates = bank.route_dropless(tokens)
            parts = []
            for idx, gate in zip(idxs, gates):
                part = torch.zeros_like(got)
                for e in range(cfg.moe_experts):
                    rows = (idx == e).nonzero()[:, 0]
                    if rows.numel() == 0:
                        continue
                    h = act(tokens[rows].to(dtype) @ bank.wi[e].to(dtype)
                            + bank.bi[e].to(dtype))
                    y = h @ bank.wo[e].to(dtype) + bank.bo[e].to(dtype)
                    part[rows] = y.to(torch.float32) * (
                        gate[rows] * cfg.moe_inference_scale)[:, None]
                parts.append(part)
            full = sum(parts)
            kept = (got - full).norm(dim=1)
            for part in parts:
                n += int(((got - full + part).norm(dim=1) < kept).sum())
    return n


def bf16_router(bank, tokens):
    """The control's fault: ``route_dropless`` with the router's product
    and softmax in bf16, where the configuration states fp32."""
    import torch
    import torch.nn.functional as F

    probs = torch.softmax(F.linear(tokens.to(torch.bfloat16),
                                   bank.router.weight.to(torch.bfloat16)),
                          dim=-1)
    remaining, idxs, gates = probs, [], []
    for _ in range(bank.cfg.moe_top_k):
        idx = torch.argmax(remaining, dim=-1)
        idxs.append(idx)
        gates.append(torch.gather(probs, -1, idx[:, None])[:, 0])
        remaining = remaining.scatter(-1, idx[:, None], -1.0)
    denom = sum(gates)
    return idxs, [(g / denom).to(torch.float32) for g in gates]


def live_rows_load(s: "Session", given, trail) -> float:
    """The decoder banks' load over the kept calls' live rows alone, in %:
    the largest expert's rows over the mean, summed over the steps. The
    staged batch's padded rows, and a row's beams once the row is past its
    limit (``beam_search`` feeds them the pad, each its beam 0), are
    computed all the same and route together."""
    import torch

    E, k, opt = s.cfg.moe_experts, s.cfg.moe_top_k, s.opt
    top = mean = 0.0
    for n, tr in trail.trails.items():
        b, K = s.batches[given[n]], tr["K"]
        sizes = np.asarray(b.src_sizes[:int(b.row_mask.sum())], np.float32)
        limit = np.floor(np.float32(opt.max_len_a) * sizes
                         + np.float32(opt.max_len_b))
        for i, pick in enumerate(tr.get("moe", [])):
            live = np.flatnonzero(limit >= i + 1)
            if live.size == 0:
                continue
            rows = torch.as_tensor((live[:, None] * K + np.arange(K))
                                   .reshape(-1), device=pick.device)
            top += float(torch.bincount(pick[:, rows].reshape(-1),
                                        minlength=E).max())
            mean += k * rows.numel() / E
    return 100.0 * top / mean if mean else 0.0


def moe_counters(run):
    """The program's counters ``moe.max_load`` and ``moe.choices`` over
    ``run()``, with the program's tracer on (its spans are dropped)."""
    from imagetranslate_tpu_torch.utils import profiling

    profiling.drain()
    profiling.enable()
    try:
        run()
    finally:
        profiling.disable()
    _, counts = profiling.drain()
    return counts


def run(cell, seed: int, seconds: float, trace: bool, device):
    config, mix = cell.config, cell.traffic
    s = Session(cell, seed, device)
    harness.phase(f"{len(s.batches)} batches, the model built")
    s.warm()
    harness.phase("warm-up")

    harness.reset_peak(device)
    stream, out = served.Stream(s.batches, s.order), served.Kept()
    counter = probes.CallCounter(s.model, "decode_step")
    trail = probes.BeamTrail(s.model, s.kept_calls())
    routes = RouteTrail(s.model, trail)
    with harness.quiet():
        window_wall = time.time()
        t0 = time.perf_counter()
        stream.deadline = t0 + seconds
        with counter, trail, routes:
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

            counts = {}

            def label_batches():
                counts.update(moe_counters(lambda: s.decode(
                    served.Stream(s.batches, s.order,
                                  limit=mix["label_batches"]),
                    served.Kept())))

            tr = harness.trace_window(traced_pass, label_batches, device,
                                      shapes, spans)
            readings["trace"] = tr
            readings["kernels"] = shapes.readings(tr)
            readings["moe"] = {"max_load": counts.get("moe.max_load", 0.0),
                               "choices": counts.get("moe.choices", 0.0),
                               "experts": config["moe_experts"]}
            dev["busy_s"] = tr.busy_s()
            dev["window_s"] = tr.window_s
            result["breakdown"] = tr.breakdown()
    result["window_wall"] = window_wall
    result["window_s"] = window_s

    harness.log(f"the decoder banks' load over the kept calls' live rows: "
                f"{live_rows_load(s, stream.given, trail):.0f} %")
    n_dropped = dropped(routes.probes)
    rows = sampled(cell, s, answers, trail)
    del routes
    s.close()
    t = time.perf_counter()
    numbers, _ = check(cell, s, rows)
    harness.log(f"the reference took {time.perf_counter() - t:.1f} s")
    numbers["wrong_lengths"] = float(failed)
    numbers["dropped_choices"] = float(n_dropped)
    return result, metrics, readings, numbers


def moe_names(config: dict, stack: str, n: int):
    """The state_dict prefixes of a stack's MoE layers, in order."""
    return [f"{stack}.layer.{i}" for i in range(n)
            if config["moe_experts"] and (i + 1) % config["moe_every"] == 0]


class RouteTrail:
    """The program's expert choices in the calls ``trail`` (a
    ``probes.BeamTrail``) keeps, on the device until the check reads them:
    each MoE call's [k, tokens] choices (``MoEFeedForward.route_dropless``);
    the encode's go with the next kept ``beam_search`` (``moe_enc``, a
    layer's each), each decode step's into its list (``moe``, the step's
    layers in turn). ``probes`` keeps the first tokens each bank routes in
    the block, for ``dropped``."""

    def __init__(self, model, trail):
        self.model, self.trail = model, trail
        self._encoding, self._enc = False, []
        self.probes = {}

    def __enter__(self):
        import torch

        from imagetranslate_tpu_torch.models import moe

        self._moe = moe
        route = self._route = moe.MoEFeedForward.route_dropless
        encode = self._encode = self.model.encode
        self._own = "encode" in vars(self.model)

        def recorded(bank, tokens):
            self.probes.setdefault(bank, tokens)
            idxs, gates = route(bank, tokens)
            pick = torch.stack(idxs)
            if self._encoding:
                self._enc.append(pick)
            elif self.trail._cur is not None:
                self.trail._cur.setdefault("moe_enc", self._enc)
                self.trail._cur.setdefault("moe", []).append(pick)
            return idxs, gates

        def encoding(*a, **kw):
            self._encoding, self._enc = True, []
            try:
                return encode(*a, **kw)
            finally:
                self._encoding = False

        moe.MoEFeedForward.route_dropless = recorded
        self.model.encode = encoding
        return self

    def __exit__(self, *exc):
        self._moe.MoEFeedForward.route_dropless = self._route
        if self._own:
            self.model.encode = self._encode
        else:
            delattr(self.model, "encode")


def beam_rows(trail: dict, rows, lengths):
    """For each batch row ``r`` that served ``n`` tokens: the beam row
    (r K + the beam) whose step i produced its token i, followed back from
    the top hypothesis as ``served.trail_paths`` follows it."""
    import torch

    K = trail["K"]
    idx = torch.stack(trail["idx"]).cpu()
    out = []
    for r, n in zip(rows, lengths):
        slot, path = 0, []
        for i in range(n - 1, -1, -1):
            parent = int(idx[i, r, slot]) // K
            path.append(r * K + parent)
            slot = parent
        out.append(path[::-1])
    return out


def sampled(cell, s: Session, answers, trail):
    """``translate.sampled``, each row with the program's routing of its
    source tokens and of its served path: ({layer: [k, source tokens]},
    {layer: [k, served tokens]})."""
    import torch

    config = cell.config
    k = config["moe_top_k"]
    enc_names = moe_names(config, "encoder.encoder", config["enc_layers"])
    dec_names = moe_names(config, "decoder.decoder", config["dec_layers"])
    kept = [a for a in answers if a[3] in trail.trails]
    pick = served.sample_rows(len(kept), [len(a[2]) for a in kept],
                              cell.traffic["check_rows"], s.seed)
    first = textgen.LANG_TOKENS[1]
    rows = []
    for n in sorted({kept[i][3] for i in pick}):
        tr = trail.trails[n]
        mine = [kept[i] for i in pick if kept[i][3] == n]
        at = [a[1] for a in mine]
        lens = [len(a[2]) for a in mine]
        paths = served.trail_paths(tr, at, lens)
        beams = beam_rows(tr, at, lens)
        enc = [e.cpu() for e in tr["moe_enc"]]
        steps = [m.cpu() for m in tr["moe"]]
        per = len(dec_names)
        for (j, r, toks, _), path, brows in zip(mine, paths, beams):
            b = s.batches[j]
            size, S = int(b.src_sizes[r]), b.src.shape[1]
            enc_r = {name: e.reshape(k, -1, S)[:, r, :size]
                     for name, e in zip(enc_names, enc)}
            dec_r = {name: torch.stack([steps[i * per + li][:, row]
                                        for i, row in enumerate(brows)],
                                       dim=1)
                     for li, name in enumerate(dec_names)}
            rows.append((b.src[r, :size], [first] + toks, path,
                         (enc_r, dec_r)))
    trail.trails.clear()
    return rows


def _routes(part, k: int, S: int, n: int):
    """The part's given routing as the reference reads it: each layer's
    [k, rows, positions], -1 where no choice is given."""
    import torch

    out = {}
    for r, (_, _, _, (enc, dec)) in enumerate(part):
        for given, T in ((enc, S), (dec, n)):
            for name, t in given.items():
                if name not in out:
                    out[name] = torch.full((k, len(part), T), -1,
                                           dtype=torch.long)
                out[name][:, r, :t.shape[1]] = t
    return out


def check(cell, s: Session, rows, control: bool = False):
    """The sampled answers against the fp32 reference replaying the
    program's routing (``reference/nllb_moe.py``): ``served.check_rows``'s
    ``topk_gap``, ``score_gap`` and ``lse_gap``, and ``route_excess`` (by
    how much, in router logits, an expert the program left out beats one it
    took, over the sampled rows' MoE tokens). With ``control``, the same
    numbers of the reference in fp8 in the program's place: its logits
    (routed by its own fp8 pipeline) against the fp32 reference replaying
    its routing. The reference's weights are the served ones in fp32, about
    36 GB at the cell's size, made once the program's state is freed; it
    runs eight rows at a time."""
    import torch

    from reference.decode import (
        control_gap,
        path_numbers,
        served_gap,
        teacher_forced_logits,
    )
    from reference.nllb_moe import NllbMoeRef
    from reference.precision import FP8, FP32, set_fp32

    set_fp32()
    device, config, opt = s.device, cell.config, s.opt
    pad, alpha, beam = s.tp.pad_token_id(), opt.len_penalty_ratio, \
        opt.beam_width
    W = s.weights()

    @torch.no_grad()
    def forward(part, prec, routes=None, record=False):
        ref = NllbMoeRef(W, config, prec)
        if routes is not None:
            ref.routes = routes
        if record:
            ref.recorded = {}
        S = max(len(row[0]) for row in part)
        src = torch.full((len(part), S), config["pad_id"], dtype=torch.long,
                         device=device)
        keep = torch.zeros((len(part), S), dtype=torch.bool, device=device)
        for r, row in enumerate(part):
            src[r, :len(row[0])] = torch.as_tensor(
                np.asarray(row[0], np.int64))
            keep[r, :len(row[0])] = True
        enc = ref.encode(src, keep)
        return teacher_forced_logits(ref, enc, keep, [row[1] for row in part],
                                     [1] * len(part), device), ref

    def worse(acc, key, value):
        acc[key] = max(acc[key], float(value))

    prog = {"topk_gap": 0.0, "score_gap": 0.0, "lse_gap": 0.0,
            "route_excess": 0.0}
    ctrl = dict(prog) if control else None
    try:
        for lo in range(0, len(rows), 8):
            part = rows[lo:lo + 8]
            S = max(len(row[0]) for row in part)
            n = max(len(row[1]) for row in part) - 1
            logits, ref = forward(part, FP32,
                                  _routes(part, config["moe_top_k"], S, n))
            worse(prog, "route_excess", ref.route_excess)
            for (_, seq, (score, lse), _), lg in zip(part, logits):
                got = list(seq[1:])
                s_ref, lse_ref = path_numbers(lg, got, alpha, pad)
                worse(prog, "topk_gap", served_gap(lg, got, beam))
                worse(prog, "score_gap", abs(score - s_ref) / abs(s_ref))
                worse(prog, "lse_gap", (torch.as_tensor(
                    lse, dtype=torch.float64) - lse_ref).abs().max())
            if not control:
                continue
            low, ref8 = forward(part, FP8, record=True)
            replay, refc = forward(part, FP32, ref8.recorded)
            worse(ctrl, "route_excess", refc.route_excess)
            for (_, seq, _, _), lo8, lg in zip(part, low, replay):
                got = list(seq[1:])
                s_ref, lse_ref = path_numbers(lg, got, alpha, pad)
                s_lo, lse_lo = path_numbers(lo8, got, alpha, pad)
                worse(ctrl, "topk_gap", control_gap(lg, lo8, beam))
                worse(ctrl, "score_gap", abs(s_lo - s_ref) / abs(s_ref))
                worse(ctrl, "lse_gap", (lse_lo - lse_ref).abs().max())
        return prog, ctrl
    finally:
        del W
        harness.free_memory(device)


def control(cell, seed: int, device, faults: bool) -> dict:
    """``translate.control`` for this layout: the program's numbers over
    the first ``control_batches`` batches of the window's order and the
    longest, and with ``faults`` the fp8 control's and those of the program
    with its router in bf16 (``bf16_router``), over the same batches."""
    from imagetranslate_tpu_torch.models import moe

    s = Session(cell, seed, device)
    picked = s.order[:cell.traffic["control_batches"]]
    picked += [i for i in [len(s.batches) - 1] if i not in picked]

    def decoded():
        stream, out = served.Stream(s.batches, picked), served.Kept()
        trail = probes.BeamTrail(s.model, range(len(picked)))
        routes = RouteTrail(s.model, trail)
        with trail, routes:
            s.decode(stream, out)
        answers, _, failed, _ = s.answers(stream, out)
        return sampled(cell, s, answers, trail), failed, routes.probes

    rows, failed, probed = decoded()
    n_dropped = dropped(probed)
    del probed
    if faults:
        route = moe.MoEFeedForward.route_dropless
        moe.MoEFeedForward.route_dropless = bf16_router
        try:
            low_rows, low_failed, _ = decoded()
        finally:
            moe.MoEFeedForward.route_dropless = route
    s.close()
    prog, lower = check(cell, s, rows, control=faults)
    res = {"program": dict(prog, wrong_lengths=float(failed),
                           dropped_choices=float(n_dropped))}
    if faults:
        res["control_fp8"] = lower
        low, _ = check(cell, s, low_rows)
        res["bf16_router"] = dict(low, wrong_lengths=float(low_failed))
    return res
