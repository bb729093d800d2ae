"""GPipe pipeline parallelism for the MT model (port of
imagetranslate_tpu/parallel/pipeline.py: ``_stage_counts``,
``split_pipeline_params``, ``merge_pipeline_params``,
``make_pipeline_forward``, ``make_mt_train_step_pp`` and
``make_mass_train_step_pp``).

The mesh's model axis is the pipeline axis (JAX's ``PP_AXIS``): stage s (the rank
at grid position (d, s)) holds a contiguous run of the encoder layers and a
contiguous run of the decoder layers (``stage_counts``: the early stages take
the remainder), and only those. Everything outside the stacks, the
embeddings, the output layer and the loss (JAX's ``rest``), is on every
stage. A stage may hold no layer of a stack (3 decoder layers over 4 stages:
1, 1, 1, 0): it passes the activations on.

JAX runs the stages SPMD inside one ``shard_map``: every stage gets
ceil(L / S) slots, short stages carry zero-filled dummy layers masked to
identities, and a ``scan`` moves the activations with a ``ppermute`` per
tick. A torch rank runs its own program, so it holds its own layers only,
and the schedule is explicit (``_Pipe``):

- the rank's rows of the data group are cut into M microbatches;
- encoder: stage 0 embeds every row; each stage takes microbatch m from the
  stage before (``recv``), runs its layers and sends the result on (``send``);
- the encoder output leaves the last stage and reaches every stage (a sum
  over the model group in which only the last stage adds);
- decoder: the same chain over the decoder layers, each cross-attending the
  encoder output of its microbatch;
- the last stage projects the whole batch and takes the loss over the count
  of the whole batch (the data group's), as JAX computes it on the
  concatenated logits: not a mean of microbatch means;
- the backward runs the chains in reverse: each stage receives a
  microbatch's output gradient, runs its layers' backward, sends the input
  gradient back. The encoder output's gradient is the sum over the decoder
  stages (a sum over the model group), and it enters the encoder's chain at
  the last stage;
- the ``rest`` parameters' gradients (stage 0's embeddings, the last
  stage's projection, both for a tied table) are summed over the model
  group, so that every stage holds the one-process gradient and takes the
  same update; the global-norm clip counts the stages' layers once each
  (``set_tensor_parallel`` with the stage's layers).

The stages run the one-process layers, so K1 takes the dropout attention
where the config asks (JAX turns its kernels off inside the ``shard_map``)
and the loss takes the one-process dispatch (K5 under ``use_pallas_xent``);
with ``cfg.remat`` each layer is recomputed (``models/remat.py``). Dropout
follows the JAX contract by distribution: each (data index, stage,
microbatch) draws from its own stream, seeded from one host draw a step.
At dropout 0 the step is the one-process step's.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.remat import checkpointed
from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq, expand_langs
from imagetranslate_tpu_torch.models.transformer import (
    DecoderLayer,
    DropoutRng,
    Embeddings,
    EncoderLayer,
    OutputLayer,
    causal_pad_bias,
    pad_bias,
    segment_bias,
)
from imagetranslate_tpu_torch.ops.masking import draw_mass, mass_mask_core
from imagetranslate_tpu_torch.parallel import comm
from imagetranslate_tpu_torch.parallel.mesh import ProcessMesh

_LAYER = re.compile(r"^(encoder\.encoder|decoder\.decoder)\.layer\.(\d+)\.")


def stage_counts(n_layers: int, stages: int) -> Tuple[List[int], int]:
    """Contiguous layer -> stage assignment; early stages take the
    remainder. Returns (counts per stage, slots = max count)."""
    base, rem = divmod(n_layers, stages)
    counts = [base + (1 if s < rem else 0) for s in range(stages)]
    return counts, max(counts)


def stage_layers(n_layers: int, stages: int, stage: int) -> range:
    """The indices of the layers stage ``stage`` holds."""
    counts, _ = stage_counts(n_layers, stages)
    lo = sum(counts[:stage])
    return range(lo, lo + counts[stage])


def _owner(key: str, cfg: Seq2SeqConfig, stages: int) -> Optional[int]:
    """The stage that holds ``key`` (a ``Seq2Seq`` state_dict key), or None
    for a ``rest`` key (every stage holds it)."""
    match = _LAYER.match(key)
    if match is None:
        return None
    n = cfg.enc_layers if match.group(1).startswith("enc") else cfg.dec_layers
    i = int(match.group(2))
    return next(s for s in range(stages)
                if i in stage_layers(n, stages, s))


def split_pipeline_params(sd: Mapping[str, torch.Tensor],
                          cfg: Seq2SeqConfig, stages: int, stage: int
                          ) -> Dict[str, torch.Tensor]:
    """A one-device ``state_dict`` -> stage ``stage``'s: the ``rest`` and its
    own layers, under their one-device keys."""
    return {k: v for k, v in sd.items()
            if _owner(k, cfg, stages) in (None, stage)}


def merge_pipeline_params(stage_sds: Sequence[Mapping[str, torch.Tensor]],
                          cfg: Seq2SeqConfig, stages: int
                          ) -> Dict[str, torch.Tensor]:
    """The stages' ``state_dict``s (stage s at index s) -> the one-device
    ``state_dict``: each layer from its stage, the ``rest`` from stage 0.
    Lossless (see ``split_pipeline_params``)."""
    out = {}
    for s, sd in enumerate(stage_sds):
        for k, v in sd.items():
            if _owner(k, cfg, stages) == s or (s == 0 and _owner(
                    k, cfg, stages) is None):
                out[k] = v
    return out


def check_pipeline(cfg: Seq2SeqConfig, mesh: Optional[ProcessMesh]) -> None:
    """The JAX pipeline's refusals (make_pipeline_forward)."""
    if cfg.lang_dec or cfg.use_proposals:
        raise ValueError(
            "pipeline parallelism supports the shared-decoder model without "
            "proposal attention")
    if mesh is None or mesh.n_model <= 1:
        raise ValueError("pipeline parallelism needs a model-axis size > 1")


class _Stack(nn.Module):
    """A stage's run of one stack: ``layer`` keyed by the one-device layer
    index, so that the stage's state_dict keys are the one-device keys."""

    def __init__(self, layers: Dict[int, nn.Module]):
        super().__init__()
        self.layer = nn.ModuleDict({str(i): m for i, m in layers.items()})


class PipelineStage(Seq2Seq):
    """Stage ``mesh.m`` of a ``Seq2Seq`` pipelined over ``mesh.n_model``
    stages: the embeddings, the output layer, and its own encoder and decoder
    layers (``stage_layers``), under the one-device state_dict keys. The
    ``Seq2Seq`` projections (``project``, ``project_topk``) and the
    ``embeddings`` are inherited; the stacks run through ``run_encoder`` and
    ``run_decoder``. Decoding goes through the merged one-device model."""

    def __init__(self, cfg: Seq2SeqConfig, mesh: ProcessMesh, device=None,
                 param_dtype=None):
        nn.Module.__init__(self)
        check_pipeline(cfg, mesh)
        self.cfg = cfg
        self.pipe_mesh = mesh
        S, s = mesh.n_model, mesh.m
        self.encoder = nn.Module()
        self.encoder.embeddings = Embeddings(cfg, device, param_dtype)
        self.encoder.encoder = _Stack({
            i: EncoderLayer(cfg, device, param_dtype)
            for i in stage_layers(cfg.enc_layers, S, s)})
        self.decoder = nn.Module()
        self.decoder.decoder = _Stack({
            i: DecoderLayer(cfg, device, param_dtype)
            for i in stage_layers(cfg.dec_layers, S, s)})
        self.output_layer = OutputLayer(cfg, device, param_dtype)

    def layer_names(self) -> List[str]:
        """The names of this stage's own layers' parameters."""
        return [k for k, _ in self.named_parameters()
                if _LAYER.match(k) is not None]

    def _run(self, layers, x, args, drop):
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in layers.values():
            x = (checkpointed(layer, drop, x, *args) if remat
                 else layer(x, *args, drop))
        return x

    def run_encoder(self, x, bias, drop: Optional[DropoutRng] = None):
        return self._run(self.encoder.encoder.layer, x, (bias,), drop)

    def run_decoder(self, x, enc, self_bias, cross_bias,
                    drop: Optional[DropoutRng] = None):
        return self._run(self.decoder.decoder.layer, x,
                         (enc, self_bias, cross_bias), drop)


def gather_pipeline_params(stage: PipelineStage) -> Dict[str, torch.Tensor]:
    """The one-device ``state_dict`` on every rank of the stage's model
    group (collective): each stage's layers summed into zeros elsewhere (one
    all-reduce, exact), the ``rest`` as this stage holds it."""
    mesh, cfg = stage.pipe_mesh, stage.cfg
    own = stage.state_dict()
    shapes = {k: v.shape for k, v in own.items()}
    # Every stage knows every layer's shape: the first layer of its kind.
    keys, dtypes = [], {}
    for kind, n in (("encoder.encoder", cfg.enc_layers),
                    ("decoder.decoder", cfg.dec_layers)):
        template = _layer_template(cfg, kind)
        for i in range(n):
            for name, (shape, dtype) in template.items():
                key = f"{kind}.layer.{i}.{name}"
                keys.append(key)
                shapes[key], dtypes[key] = shape, dtype
    device = next(iter(own.values())).device
    flat = torch.zeros(sum(int(torch.Size(shapes[k]).numel()) for k in keys),
                       dtype=torch.float32, device=device)
    offsets, at = {}, 0
    for k in keys:
        n = int(torch.Size(shapes[k]).numel())
        offsets[k] = (at, n)
        if k in own:
            flat[at:at + n] = own[k].reshape(-1)
        at += n
    comm.all_reduce_sum(flat, mesh.model_group)
    out = {k: v for k, v in own.items() if _owner(k, cfg, mesh.n_model)
           is None}
    for k in keys:
        at, n = offsets[k]
        out[k] = flat[at:at + n].reshape(shapes[k]).to(dtypes[k])
    return out


def _layer_template(cfg: Seq2SeqConfig, kind: str):
    """{name: (shape, dtype)} of one layer's parameters of the stack
    ``kind``, from a layer built on the meta device."""
    cls = EncoderLayer if kind.startswith("enc") else DecoderLayer
    layer = cls(cfg, device="meta", param_dtype=torch.float32)
    return {k: (tuple(v.shape), v.dtype)
            for k, v in layer.state_dict().items()}


class _Pipe:
    """The GPipe schedule of one step on this rank: its neighbours' global
    ranks, the microbatch rows, the dropout streams."""

    def __init__(self, stage: PipelineStage, n_micro: int, rows: int,
                 seed: int, device):
        mesh = stage.pipe_mesh
        self.params = dict(stage.named_parameters())
        self.S, self.s, self.M = mesh.n_model, mesh.m, int(n_micro)
        if rows % self.M:
            raise ValueError(f"local batch {rows} not divisible by "
                             f"{self.M} microbatches")
        self.rows = rows // self.M
        first = mesh.d * self.S
        self.prev = first + self.s - 1 if self.s > 0 else None
        self.next = first + self.s + 1 if self.s < self.S - 1 else None
        self.mesh, self.device, self.seed = mesh, device, seed

    def stream(self, kind: int, m: int) -> DropoutRng:
        """The dropout stream of (kind, data index, stage, microbatch): kind
        0 the encoder stack, 1 the decoder stack, 2 / 3 stage 0's encoder /
        decoder embeddings."""
        key = (((kind * self.mesh.n_data + self.mesh.d) * self.S + self.s)
               * (self.M + 1) + m)
        gen = torch.Generator().manual_seed(
            (self.seed * 1_000_003 + key) % (1 << 62))
        return DropoutRng(gen, self.device)

    def mb(self, t: torch.Tensor, m: int) -> torch.Tensor:
        return t[m * self.rows:(m + 1) * self.rows]

    def forward(self, run, shape, dtype, xs, args, kind: int):
        """One stack's forward chain over the microbatches: ``xs`` the inputs
        at stage 0 (None elsewhere), ``args(m)`` the layers' other
        arguments. Returns (inputs, outputs) per microbatch; the outputs
        keep their graph."""
        ins, outs = [], []
        for m in range(self.M):
            x = (xs[m] if self.prev is None
                 else comm.recv(shape, dtype, self.device, self.prev))
            x = x.detach().requires_grad_()
            y = run(x, *args(m), self.stream(kind, m))
            if self.next is not None:
                comm.send(y, self.next)
            ins.append(x)
            outs.append(y)
        return ins, outs

    def backward(self, ins, outs, grads_out, params, extra=None):
        """One stack's backward chain, microbatches in reverse: the output
        gradient from the loss (``grads_out``, the last stage) or the next
        stage, the input gradient to the stage before. Accumulates into
        ``params`` (name -> gradient or None) and returns the input
        gradients per microbatch (stage 0's) and those of ``extra`` (one
        leaf per microbatch, or None)."""
        names = list(params)
        tensors = [self.params[k] for k in names]
        dxs: List[Optional[torch.Tensor]] = [None] * self.M
        dextra: List[Optional[torch.Tensor]] = [None] * self.M
        for m in reversed(range(self.M)):
            g = (grads_out[m] if self.next is None
                 else comm.recv(outs[m].shape, outs[m].dtype, self.device,
                                self.next))
            if outs[m] is ins[m]:               # no layer here: pass it on
                dx, rest = g, [None] * (len(tensors) + (extra is not None))
            else:
                inputs = [ins[m]] + ([extra[m]] if extra is not None else [])
                got = torch.autograd.grad(outs[m], inputs + tensors, g,
                                          allow_unused=True)
                dx, rest = got[0], list(got[1:])
            if extra is not None:
                dextra[m] = rest.pop(0)
            for k, gp in zip(names, rest):
                if gp is not None:
                    params[k] = gp if params[k] is None else params[k] + gp
            if dx is None:
                dx = torch.zeros_like(ins[m])
            if self.prev is not None:
                comm.send(dx, self.prev)
            dxs[m] = dx
        return dxs, dextra


def _pipelined_update(stage: PipelineStage, optimizer, state, n_micro: int,
                      inputs: Dict[str, torch.Tensor], targets, mask,
                      loss_impl, label_smoothing: float,
                      seed: int):
    """One pipelined forward and backward of the teacher-forced model on
    ``inputs`` (the ``Seq2Seq.forward`` arguments, this rank's rows), the
    loss of ``targets`` under ``mask`` over the data group's count, the
    update in place. Returns (state, metrics) on every rank."""
    from imagetranslate_tpu_torch.train.step import apply_grads

    cfg, mesh = stage.cfg, stage.pipe_mesh
    src, tgt = inputs["src"], inputs["tgt"]
    device = src.device
    B, S_len = src.shape
    T = tgt.shape[1]
    pipe = _Pipe(stage, n_micro, B, seed, device)
    dtype = cfg.compute_dtype
    E = cfg.hidden_size
    src_seg, tgt_seg = inputs.get("src_seg"), inputs.get("tgt_seg")
    src_bias = (pad_bias(inputs["src_mask"]) if src_seg is None
                else segment_bias(src_seg, src_seg))
    if tgt_seg is None:
        self_bias = causal_pad_bias(inputs["tgt_mask"][:, :-1])
        cross_bias = pad_bias(inputs["src_mask"])
    else:
        tseg = tgt_seg[:, :-1]
        self_bias = segment_bias(tseg, tseg, causal=True)
        cross_bias = segment_bias(tseg, src_seg)

    def rows(t, m):
        # A bias broadcast over the batch (size 1) serves every microbatch;
        # a slice is copied, so that it starts 16-byte aligned, as K1 asks
        # (a run of rows x 63 x 63 fp32 need not).
        return t if t.shape[0] == 1 else pipe.mb(t, m).clone()

    # ---- encoder ----
    emb = None
    if pipe.prev is None:
        pos = inputs.get("src_pos")
        if pos is None:
            pos = torch.arange(S_len, device=device)[None, :].expand(B, S_len)
        emb = stage.embeddings(src, pos, expand_langs(inputs["src_langs"],
                                                      S_len),
                               pipe.stream(2, 0))
    xs = None if emb is None else [pipe.mb(emb, m) for m in range(pipe.M)]
    e_in, e_out = pipe.forward(stage.run_encoder, (pipe.rows, S_len, E),
                               dtype, xs, lambda m: (rows(src_bias, m),), 0)
    # The encoder output, from the last stage to every stage.
    enc = (torch.cat([y.detach() for y in e_out]) if pipe.next is None
           else torch.zeros((B, S_len, E), dtype=dtype, device=device))
    enc = comm.all_reduce_sum(enc, mesh.model_group)
    enc_leaves = [pipe.mb(enc, m).detach().requires_grad_()
                  for m in range(pipe.M)]

    # ---- decoder ----
    temb = None
    if pipe.prev is None:
        tpos = inputs.get("tgt_pos")
        tpos = (torch.arange(T - 1, device=device)[None, :].expand(B, T - 1)
                if tpos is None else tpos[:, :-1])
        temb = stage.embeddings(tgt[:, :-1], tpos,
                                expand_langs(inputs["tgt_langs"], T)[:, :-1],
                                pipe.stream(3, 0))
    xts = None if temb is None else [pipe.mb(temb, m) for m in range(pipe.M)]
    d_in, d_out = pipe.forward(
        stage.run_decoder, (pipe.rows, T - 1, E), dtype, xts,
        lambda m: (enc_leaves[m], rows(self_bias, m), rows(cross_bias, m)),
        1)

    # ---- the loss, on the last stage, over the whole batch ----
    params = {k: None for k in pipe.params}
    sums = torch.zeros(2, dtype=torch.float32, device=device)
    d_hid = None
    if pipe.next is None:
        logits = stage.project(torch.cat(d_out))
        sum_l, n = loss_impl(logits, targets, mask, epsilon=label_smoothing)
        n = comm.all_reduce_sum(n.detach().clone(), mesh.data_group)
        n = torch.clamp(n, min=1.0)
        objective = sum_l / n
        rest = [k for k in params if _owner(k, cfg, pipe.S) is None]
        got = torch.autograd.grad(
            objective, list(d_out) + [pipe.params[k] for k in rest],
            allow_unused=True)
        d_hid = list(got[:pipe.M])
        for k, g in zip(rest, got[pipe.M:]):
            params[k] = g
        sums = torch.stack([comm.all_reduce_sum(sum_l.detach().clone(),
                                                mesh.data_group), n])
    dec_params = {k: None for k in params if k.startswith("decoder.")}
    dxts, d_enc = pipe.backward(d_in, d_out, d_hid, dec_params, enc_leaves)
    enc_params = {k: None for k in params if k.startswith("encoder.encoder")}
    # The encoder output's gradient: the sum over the decoder stages.
    g_enc = torch.cat([torch.zeros_like(leaf) if g is None else g
                       for leaf, g in zip(enc_leaves, d_enc)])
    g_enc = comm.all_reduce_sum(g_enc, mesh.model_group)
    dxs, _ = pipe.backward(e_in, e_out,
                           [pipe.mb(g_enc, m) for m in range(pipe.M)],
                           enc_params)
    if emb is not None:
        rest = [k for k in params if _owner(k, cfg, pipe.S) is None]
        got = torch.autograd.grad(
            [emb, temb], [pipe.params[k] for k in rest],
            [torch.cat(dxs), torch.cat(dxts)], allow_unused=True)
        for k, g in zip(rest, got):
            if g is not None:
                params[k] = g if params[k] is None else params[k] + g
    params.update({k: v for k, v in dec_params.items() if v is not None})
    params.update({k: v for k, v in enc_params.items() if v is not None})

    grads = [torch.zeros_like(p) if params[k] is None else params[k]
             for k, p in pipe.params.items()]
    # The rest's gradients: stage 0's and the last stage's, summed.
    rest_idx = [i for i, k in enumerate(pipe.params)
                if _owner(k, cfg, pipe.S) is None]
    flat = comm.all_reduce_sum(
        torch.cat([grads[i].reshape(-1) for i in rest_idx]), mesh.model_group)
    for i, f in zip(rest_idx, flat.split([grads[i].numel()
                                          for i in rest_idx])):
        grads[i] = f.view_as(grads[i])
    apply_grads(state, optimizer, grads, mesh)
    # Every rank reports the last stage's metrics.
    sums = comm.all_reduce_sum(sums, mesh.model_group)
    return state, {"sum_loss": sums[0], "ntokens": sums[1]}


def _seed(rng) -> int:
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=rng))


def make_mt_train_step_pp(stage: PipelineStage, optimizer, n_micro: int,
                          label_smoothing: float = 0.1):
    """Pipeline-parallel twin of ``train/step.py::make_mt_train_step``: the
    same batch contract (padded or packed rows, this rank's rows of the data
    group) and metrics; ``state.params`` is the stage's
    ``dict(named_parameters())``."""
    from imagetranslate_tpu_torch.train.step import _loss_impl

    loss_impl = _loss_impl(stage)

    def step_fn(state, batch: Dict[str, torch.Tensor], rng: torch.Generator):
        packed = "src_seg" in batch
        if packed:
            inputs = {"src": batch["src"], "src_mask": batch["src_seg"] > 0,
                      "tgt": batch["dst"], "tgt_mask": batch["dst_seg"] > 0,
                      "src_langs": batch["src_langs"],
                      "tgt_langs": batch["dst_langs"],
                      "src_pos": batch["src_pos"], "tgt_pos": batch["dst_pos"],
                      "src_seg": batch["src_seg"], "tgt_seg": batch["dst_seg"]}
            seg = batch["dst_seg"]
            mask = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] > 0)
        else:
            inputs = {"src": batch["src"], "src_mask": batch["src_mask"],
                      "tgt": batch["dst"], "tgt_mask": batch["dst_mask"],
                      "src_langs": batch["src_langs"],
                      "tgt_langs": batch["dst_langs"],
                      "tgt_pos": batch.get("tgt_positions")}
            mask = batch["dst_mask"][:, 1:] & batch["row_mask"][:, None]
        return _pipelined_update(stage, optimizer, state, n_micro, inputs,
                                 batch["dst"][:, 1:], mask, loss_impl,
                                 label_smoothing, _seed(rng))

    return step_fn


def make_mass_train_step_pp(stage: PipelineStage, optimizer, n_micro: int,
                            mask_prob: float = 0.5, n_specials: int = 5,
                            mask_id: int = 3, label_smoothing: float = 0.1):
    """Pipeline-parallel twin of ``make_mass_train_step``: the same span
    draws (every stage of a data index draws the same spans, from the
    one-process step's generator shifted by the data index), the pipelined
    forward."""
    from imagetranslate_tpu_torch.train.step import _loss_impl

    cfg = stage.cfg
    loss_impl = _loss_impl(stage)

    def step_fn(state, batch: Dict[str, torch.Tensor], rng: torch.Generator):
        src = batch["src"]
        draw = DropoutRng(rng, src.device, stage.pipe_mesh)
        draws = draw_mass(draw.dev, src, batch["lengths"], mask_prob,
                          n_specials=n_specials, vocab_size=cfg.vocab_size)
        masked = mass_mask_core(
            draws, src, batch["lengths"], mask_prob, mask_id=mask_id,
            pad_id=cfg.pad_id, span_width=src.shape[1] // 2 + 1)
        dec_mask = masked.dec_inputs != cfg.pad_id
        inputs = {"src": masked.src, "src_mask": batch["src_mask"],
                  "tgt": masked.dec_inputs, "tgt_mask": dec_mask,
                  "src_langs": batch["langs"], "tgt_langs": batch["langs"],
                  "tgt_pos": masked.positions}
        mask = dec_mask[:, 1:] & batch["row_mask"][:, None]
        return _pipelined_update(stage, optimizer, state, n_micro, inputs,
                                 masked.dec_inputs[:, 1:], mask, loss_impl,
                                 label_smoothing, draw.next_seed())

    return step_fn
