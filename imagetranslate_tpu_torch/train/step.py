"""The MT, MASS, MLM, SenSim, Caption2Image and caption train steps (port of
imagetranslate_tpu/train/step.py: TrainState, create_train_state, wrap_accum,
make_mt_train_step for padded and packed batches, make_mass_train_step,
make_mlm_train_step, make_mlm_eval_step, make_sensim_train_step,
make_caption2image_train_step, CaptionTrainState,
create_caption_train_state, make_caption_train_step,
make_caption_obj_train_step, make_caption_mt_train_step, the multimodal
steps make_multimodal_mass_step, make_text_mass_step_mm and
make_contrastive_step, and the batch staging helpers).

The JAX step is a pure function of an immutable state. Here the parameters
are the model's own ``nn.Parameter``s and the step updates them, and the
optimizer state, IN PLACE (no second copy of the fp32 masters); it returns
the same ``TrainState`` with ``step`` advanced. Metrics are device scalars
(sum_loss, ntokens): nothing in a step waits for the device.

Spans (``utils/profiling.py``): ``train.forward`` around the MT and MASS
steps' model call and loss, ``train.backward`` around ``_descend``'s
``autograd.grad`` (every step here), ``train.optimizer`` around
``apply_grads``.

A model with MoE FFNs (``cfg.moe_experts > 0``) adds ``cfg.moe_aux_weight``
times the mean of its expert banks' load-balance losses to every training
objective, as each JAX step does; a dense model's objective is what it was.
Evaluation applies no such term.

Under a mesh (the model's ``mesh``, set by ``Seq2Seq.shard_``) the MT and
MASS steps hold the JAX program's global batch semantics: the loss is the
data group's sum over its count, and each rank's gradients (of its sum over
that global count) are summed over the data group before the update. With
the vocab split over the model group the loss is
``smoothed_nll_loss_vocab_parallel``; under pure data parallelism each rank
holds the whole vocab and keeps the fused kernels where the config asks.

The other families hold the same contract under a mesh: every sum JAX takes
over the batch is global. The MLM step draws the global batch's masks from
a seed every rank shares and takes its slice, switches to the
masked-budget projection on the global B * T, and orders the global mask
(``_mlm_positions``); under sequence parallelism (``LongDocLM`` over a
model axis) the positions of a row are split over the model group as well,
and the sums and the gradients are summed over it too. The contrastive,
SenSim and Caption2Image steps divide by the global count of rows, the
InfoNCE steps over vectors all-gathered over the data group. Under a data
group a batch lists the arrays whose rows it did not split (the data axis
does not divide them; each rank holds all of them) under ``"_whole"``
(``shard_batch_safe``, ``mark_whole``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from imagetranslate_tpu_torch.models.moe import collect_aux
from imagetranslate_tpu_torch.models.transformer import DropoutRng
from imagetranslate_tpu_torch.ops.losses import (
    nll_loss,
    smoothed_nll_loss,
    smoothed_nll_loss_vocab_parallel,
)
from imagetranslate_tpu_torch.ops.masking import (
    MassDraws,
    MLMDraws,
    draw_mass,
    draw_mlm,
    mask_text_core,
    mass_mask_core,
)
from imagetranslate_tpu_torch.ops.xent import smoothed_nll_loss_fused
from imagetranslate_tpu_torch.parallel.comm import (
    all_gather_stack,
    all_reduce_sum,
)
from imagetranslate_tpu_torch.train.optimizer import (
    AnyOptState,
    MultiSteps,
    Optimizer,
)
from imagetranslate_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]   # dict(model.named_parameters())
    opt_state: AnyOptState
    step: int


def create_train_state(params: Dict[str, torch.Tensor],
                       optimizer: Optimizer) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def wrap_accum(optimizer, accum: int):
    """Gradient accumulation: the mean of ``accum`` micro-gradients, one
    update every ``accum``-th step (optax.MultiSteps semantics)."""
    if accum and accum > 1:
        return MultiSteps(optimizer, accum)
    return optimizer


def _loss_impl(model) -> Callable:
    """The fused softmax-xent kernels (ops/xent.py) when the model config
    asks for them (``use_pallas_xent``: the key keeps the name both packages
    read from config.json); the same function either way. Logits split over
    the vocab take the vocab-parallel loss."""
    tp = getattr(model, "vocab_tp", None)
    if tp is not None:
        lo = model.vocab_range()[0]

        def vocab_parallel(logits, targets, mask, epsilon):
            return smoothed_nll_loss_vocab_parallel(
                logits, targets, mask, epsilon, lo, model.cfg.vocab_size,
                tp.model_group)

        return vocab_parallel
    if getattr(model.cfg, "use_pallas_xent", False):
        return smoothed_nll_loss_fused
    return smoothed_nll_loss


def _with_aux(model, fn, *args, **kw):
    """(``fn(*args, **kw)``, the weighted load-balance term): for a model
    with MoE FFNs ``cfg.moe_aux_weight`` times the mean of the losses its
    expert banks reported during the call (one a bank a call, the mean over
    the sown values of the JAX ``_apply_with_aux``); None for a dense model,
    whose objective then gains nothing."""
    if not model.cfg.moe_experts:
        return fn(*args, **kw), None
    with collect_aux(model) as sink:
        out = fn(*args, **kw)
    return out, model.cfg.moe_aux_weight * (sum(sink) / len(sink))


def _plus(objective, aux):
    return objective if aux is None else objective + aux


def _descend(state, optimizer: Optimizer, objective, mesh=None,
             seq: bool = False) -> None:
    """Backward of the scalar ``objective`` (span ``train.backward``), then
    ``apply_grads``."""
    params = list(state.params.values())
    with span("train.backward"):
        grads = torch.autograd.grad(objective, params, allow_unused=True)
        # A parameter the batch did not reach (another language's decoder)
        # gets a zero gradient, as jax.grad gives it.
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
    apply_grads(state, optimizer, grads, mesh, seq)


def _flat_sum(grads, group):
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
    return [f.view_as(g) for f, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def apply_grads(state, optimizer: Optimizer, grads, mesh=None,
                seq: bool = False) -> None:
    """The gradients (one per ``state.params`` entry, this rank's) summed
    over the mesh's data group, the optimizer update in place. Under ZeRO-1
    (``optimizer.zero``) the split parameters' gradients are
    reduce-scattered instead, and the update all-gathers their slices.
    ``seq``: the model group holds other positions of the same rows
    (sequence parallelism, the parameters whole on every rank), so the
    gradients are summed over it too. Span ``train.optimizer``."""
    with span("train.optimizer"):
        if seq and mesh is not None and mesh.model_group is not None:
            grads = _flat_sum(grads, mesh.model_group)
        if mesh is not None and mesh.data_group is not None:
            zero = getattr(optimizer, "zero", None)
            if zero is not None:
                grads = zero.reduce_grads(grads, list(state.params))
            else:
                grads = _flat_sum(grads, mesh.data_group)
        optimizer.update(grads, state.opt_state, state.params)
    state.step += 1


def _row_groups(mesh, seq: bool = False):
    """The groups whose ranks hold other rows (or, under sequence
    parallelism, other positions) of the global batch: a sum over the batch
    is summed over them."""
    if mesh is None:
        return []
    groups = [mesh.data_group]
    if seq:
        groups.append(mesh.model_group)
    return [g for g in groups if g is not None]


def _global(x: torch.Tensor, mesh, seq: bool = False) -> torch.Tensor:
    """The batch-wide sum of this rank's share ``x`` (a new tensor, no
    gradient)."""
    x = x.detach().clone()
    for g in _row_groups(mesh, seq):
        x = all_reduce_sum(x, g)
    return x


def _update(state, optimizer: Optimizer, sum_l, n, weight: float = 1.0,
            aux=None, mesh=None, seq: bool = False):
    """Backward of weight * sum_l / n (+ ``aux``, the weighted MoE term),
    the optimizer update in place, the metrics (the unweighted sum). Under
    ``mesh`` n is the batch-wide count (at least 1) and the metrics the
    batch-wide sums."""
    n = torch.clamp(_global(n, mesh, seq), min=1.0)
    _descend(state, optimizer, _plus(weight * sum_l / n, aux), mesh, seq)
    return state, {"sum_loss": _global(sum_l, mesh, seq), "ntokens": n}


def _split(batch, key: str) -> bool:
    """Were ``batch[key]``'s rows split over the data group?"""
    return key not in batch.get("_whole", ())


def mark_whole(batch: Dict, keys, rows: slice) -> Dict:
    """Record that ``keys`` stayed whole on every rank when ``rows`` (the
    host slice they were staged with) is all of them; returns ``batch``."""
    if rows == slice(None):
        batch["_whole"] = frozenset(batch.get("_whole", ())) | set(keys)
    return batch


def make_mt_train_step(model, optimizer: Optimizer,
                       label_smoothing: float = 0.1) -> Callable:
    """Returns ``step_fn(state, batch, rng) -> (state, metrics)``. ``batch``
    is a dict of tensors on the model's device, padded (``src_mask`` ...) or
    packed (``src_seg`` ...; ``mt_batch_to_device`` /
    ``packed_mt_batch_to_device``); ``rng`` is the host torch.Generator the
    dropout seeds of this step are drawn from. ``state.params`` must be this
    model's ``dict(named_parameters())``. Under the model's mesh the batch
    holds this rank's rows (``parallel.mesh.shard_batch_safe``)."""
    loss_fn_impl = _loss_impl(model)
    mesh = getattr(model, "mesh", None)

    def forward(batch, rng):
        if "src_seg" in batch:
            logits, aux = _with_aux(
                model, model,
                batch["src"], batch["src_seg"] > 0, batch["dst"],
                batch["dst_seg"] > 0, batch["src_langs"], batch["dst_langs"],
                tgt_positions=batch["dst_pos"],
                src_positions=batch["src_pos"],
                src_segments=batch["src_seg"], tgt_segments=batch["dst_seg"],
                deterministic=False, rng=rng)
            seg = batch["dst_seg"]
            # Position t is a valid loss target only when t-1 belongs to
            # the same example: cross-boundary slots are excluded.
            mask = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] > 0)
        else:
            logits, aux = _with_aux(
                model, model,
                batch["src"], batch["src_mask"], batch["dst"],
                batch["dst_mask"], batch["src_langs"], batch["dst_langs"],
                tgt_positions=batch.get("tgt_positions"),
                proposals=batch.get("proposals"),
                proposal_mask=batch.get("proposal_mask"),
                deterministic=False, rng=rng)
            mask = batch["dst_mask"][:, 1:] & batch["row_mask"][:, None]
        sum_l, n = loss_fn_impl(logits, batch["dst"][:, 1:], mask,
                                epsilon=label_smoothing)
        return sum_l, n, aux

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                rng: torch.Generator):
        with span("train.forward"):
            sum_l, n, aux = forward(batch, rng)
        return _update(state, optimizer, sum_l, n, aux=aux, mesh=mesh)

    return step_fn


def make_mass_train_step(model, optimizer: Optimizer, cfg,
                         mask_prob: float = 0.5, n_specials: int = 5,
                         mask_id: int = 3,
                         label_smoothing: float = 0.1) -> Callable:
    """MASS pretraining step: corrupt a span of each source row on the
    device, then predict the span from the corrupted row.

    Returns ``step_fn(state, batch, rng, draws=None) -> (state, metrics)``.
    ``batch``: ``mass_batch_to_device``'s dict (src [B, S], src_mask, langs,
    lengths, row_mask). ``rng``: the host torch.Generator; it seeds the
    device generator that the span draws and the dropout masks come from.
    ``draws``: a ``MassDraws`` to use in place of drawing (the tests feed the
    JAX package's draws). Under the model's mesh as ``make_mt_train_step``;
    each data rank draws the spans of its own rows."""
    loss_fn_impl = _loss_impl(model)
    mesh = getattr(model, "mesh", None)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                rng: torch.Generator, draws: Optional[MassDraws] = None):
        src = batch["src"]
        drop = DropoutRng(rng, src.device, mesh)
        if draws is None:
            draws = draw_mass(drop.dev, src, batch["lengths"], mask_prob,
                              n_specials=n_specials,
                              vocab_size=cfg.vocab_size)
        masked = mass_mask_core(
            draws, src, batch["lengths"], mask_prob, mask_id=mask_id,
            pad_id=cfg.pad_id, span_width=src.shape[1] // 2 + 1)
        dec_mask = masked.dec_inputs != cfg.pad_id
        with span("train.forward"):
            logits, aux = _with_aux(
                model, model, masked.src, batch["src_mask"],
                masked.dec_inputs, dec_mask, batch["langs"], batch["langs"],
                tgt_positions=masked.positions, deterministic=False,
                rng=drop)
            mask = dec_mask[:, 1:] & batch["row_mask"][:, None]
            sum_l, n = loss_fn_impl(logits, masked.dec_inputs[:, 1:], mask,
                                    epsilon=label_smoothing)
        return _update(state, optimizer, sum_l, n, aux=aux, mesh=mesh)

    return step_fn


MLM_BUDGET_MIN_TOKENS = 8192   # B * T from which the budget projection runs


def mlm_budget(n_tokens: int, mask_prob: float) -> int:
    """Rows the masked-budget projection keeps: twice the expected masked
    count, rounded up to 128."""
    return -(-int(n_tokens * min(1.0, 2.0 * mask_prob)) // 128) * 128


def _mlm_nll(model) -> Callable:
    """The MLM's plain NLL over the model's logits: vocab-parallel where
    the model splits the vocab."""
    tp = getattr(model, "vocab_tp", None)
    if tp is None:
        return nll_loss
    lo = model.vocab_range()[0]

    def vocab_parallel(logits, targets, mask):
        return smoothed_nll_loss_vocab_parallel(
            logits, targets, mask, 0.0, lo, model.cfg.vocab_size,
            tp.model_group)

    return vocab_parallel


def _mlm_layout(model, texts):
    """(mesh, seq, global B, global T, first row, first position) of this
    rank's [B, T] share of the MLM batch. Under a data group the rows are
    split (the LM trainers refuse batches the data axis does not divide);
    under sequence parallelism (``seq``) the positions too."""
    mesh = getattr(model, "mesh", None)
    B, T = texts.shape
    if mesh is None:
        return None, False, B, T, 0, 0
    seq = bool(getattr(model, "seq_parallel", False))
    n_model = mesh.n_model if seq else 1
    return (mesh, seq, B * mesh.n_data, T * n_model, mesh.d * B,
            (mesh.m if seq else 0) * T)


def _local_draws(draws: MLMDraws, layout, B: int, T: int) -> MLMDraws:
    """This rank's [B, T] slice of the global batch's draws (draws of the
    share itself pass through)."""
    r0, c0 = layout[4:]
    if tuple(draws.sel.shape) == (B, T):
        return draws
    return MLMDraws(*(d[r0:r0 + B, c0:c0 + T] for d in draws))


def _mlm_draws(gen, layout, texts, n_specials: int,
               vocab_size: int) -> MLMDraws:
    """The draws of this rank's share: those of the global batch from
    ``gen`` (seeded alike on every rank), sliced."""
    Bg, Tg = layout[2:4]
    full = draw_mlm(gen, texts.new_empty((Bg, Tg)), n_specials=n_specials,
                    vocab_size=vocab_size)
    return _local_draws(full, layout, *texts.shape)


def _global_mask(mask: torch.Tensor, layout) -> torch.Tensor:
    """The global [B, T] int8 mask from every rank's share."""
    mesh, seq = layout[:2]
    m = mask.to(torch.int8)
    if seq and mesh.model_group is not None:
        parts = all_gather_stack(m, mesh.model_group)        # [M, B, t]
        m = parts.permute(1, 0, 2).reshape(m.shape[0], -1)
    if mesh.data_group is not None:
        m = all_gather_stack(m, mesh.data_group).flatten(0, 1)
    return m


def _mlm_positions(mask: torch.Tensor, budget: int, layout) -> torch.Tensor:
    """Flat indices into this rank's [B * T] share of the positions the
    budget projection takes: the first ``budget`` of the global order (the
    masked positions first, each group in index order: a stable descending
    sort of the 0/1 vector is what top_k gives in JAX, where torch.topk
    promises no order among equals), those this rank holds."""
    if layout[0] is None:
        return torch.argsort(mask.reshape(-1).to(torch.int8),
                             descending=True, stable=True)[:budget]
    Tg, r0, c0 = layout[3:]
    B, T = mask.shape
    flat = _global_mask(mask, layout).reshape(-1)
    order = torch.argsort(flat, descending=True, stable=True)[:budget]
    rows, cols = order // Tg - r0, order % Tg - c0
    held = (rows >= 0) & (rows < B) & (cols >= 0) & (cols < T)
    return (rows * T + cols)[held]


def make_mlm_train_step(model, optimizer: Optimizer, cfg,
                        mask_prob: float = 0.15, n_specials: int = 5,
                        mask_id: int = 3) -> Callable:
    """MLM step: 80/10/10 corruption on the device, then plain NLL at the
    masked positions.

    Masked-budget projection: the loss reads only about ``mask_prob`` of the
    positions, while projecting every position stores [B * T, V] fp32 logits.
    From B * T >= 8192 (of the global batch) the step gathers a fixed budget
    of positions (the masked ones first, in index order; ``mlm_budget``)
    and projects only those. A masked count above the budget (a many-sigma
    event at that size) drops the masked positions of the highest indices,
    as the JAX step does. Smaller batches project every position.

    Returns ``step_fn(state, batch, rng, draws=None) -> (state, metrics)``.
    ``batch``: ``lm_batch_to_device``'s dict (texts [B, T], pad_mask, langs,
    row_mask), under the model's mesh this rank's share. ``rng``: the host
    torch.Generator; it seeds the device generator that the mask draws and
    the dropout masks come from (under a mesh the masks come from a
    generator every rank seeds alike, drawn over the global shape).
    ``draws``: an ``MLMDraws`` to use in place of drawing, of the global
    batch or of this rank's share (the tests feed the JAX package's
    draws)."""
    loss_fn = _mlm_nll(model)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                rng: torch.Generator, draws: Optional[MLMDraws] = None):
        texts = batch["texts"]
        B, T = texts.shape
        layout = _mlm_layout(model, texts)
        mesh, seq, Bg, Tg = layout[:4]
        drop = DropoutRng(rng, texts.device, mesh, seq)
        if draws is not None:
            draws = _local_draws(draws, layout, B, T)
        elif mesh is None:
            draws = draw_mlm(drop.dev, texts, n_specials=n_specials,
                             vocab_size=cfg.vocab_size)
        else:
            gen = torch.Generator(device=texts.device)
            gen.manual_seed(drop.seed)
            draws = _mlm_draws(gen, layout, texts, n_specials,
                               cfg.vocab_size)
        masked = mask_text_core(draws, texts, batch["pad_mask"], mask_prob,
                                mask_id=mask_id, eos_id=cfg.eos_id)
        mask = masked.target_mask & batch["row_mask"][:, None]
        if Bg * Tg >= MLM_BUDGET_MIN_TOKENS:
            h, aux = _with_aux(model, model.encode, masked.texts,
                               batch["pad_mask"], batch["langs"],
                               deterministic=False, rng=drop)
            at = _mlm_positions(mask, mlm_budget(Bg * Tg, mask_prob), layout)
            logits = model.project_hidden(h.reshape(B * T, -1)[at])
            sum_l, n = loss_fn(logits, texts.reshape(-1)[at],
                               mask.reshape(-1)[at])
        else:
            logits, aux = _with_aux(model, model, masked.texts,
                                    batch["pad_mask"], batch["langs"],
                                    deterministic=False, rng=drop)
            sum_l, n = loss_fn(logits, texts, mask)
        return _update(state, optimizer, sum_l, n, aux=aux, mesh=mesh,
                       seq=seq)

    return step_fn


def make_mlm_eval_step(model, cfg, mask_prob: float = 0.15,
                       n_specials: int = 5, mask_id: int = 3) -> Callable:
    """Dev loss of the MLM. Returns ``eval_fn(batch, gen, draws=None) ->
    (sum_loss, count)``: ``gen`` is a generator on the batch's device that
    the mask draws come from; the model runs deterministically on all
    positions, without gradients. Under the model's mesh the batch is this
    rank's share, the draws are those of the global batch (``gen`` seeded
    alike on every rank) and the sums global."""
    loss_fn = _mlm_nll(model)

    @torch.no_grad()
    def eval_fn(batch: Dict[str, torch.Tensor], gen: Optional[torch.Generator],
                draws: Optional[MLMDraws] = None):
        texts = batch["texts"]
        B, T = texts.shape
        layout = _mlm_layout(model, texts)
        if draws is not None:
            draws = _local_draws(draws, layout, B, T)
        elif layout[0] is None:
            draws = draw_mlm(gen, texts, n_specials=n_specials,
                             vocab_size=cfg.vocab_size)
        else:
            draws = _mlm_draws(gen, layout, texts, n_specials,
                               cfg.vocab_size)
        masked = mask_text_core(draws, texts, batch["pad_mask"], mask_prob,
                                mask_id=mask_id, eos_id=cfg.eos_id)
        logits = model(masked.texts, batch["pad_mask"], batch["langs"])
        mask = masked.target_mask & batch["row_mask"][:, None]
        sum_l, n = loss_fn(logits, texts, mask)
        if layout[0] is None:
            return sum_l, n
        return (_global(sum_l, *layout[:2]), _global(n, *layout[:2]))

    return eval_fn


def _row_count(batch, key: str, mesh):
    """The batch-wide count of real rows (``row_mask``; all rows without
    one), no gradient."""
    if "row_mask" in batch:
        n = batch["row_mask"].to(torch.float32).sum()
    else:
        n = torch.tensor(float(batch[key].shape[0]),
                         device=batch[key].device)
    return _global(n, mesh)


def _data_group(model, batch, key: str):
    """The data group when ``batch[key]``'s rows were split over it, else
    None (each rank then holds all of them)."""
    mesh = getattr(model, "mesh", None)
    if mesh is None or mesh.data_group is None or not _split(batch, key):
        return None
    return mesh.data_group


def make_sensim_train_step(model, optimizer: Optimizer) -> Callable:
    """SenSim's InfoNCE step (``SenSim.forward``). ``batch``: the pair
    (``src``, ``src_mask``, ``src_langs``, ``dst``, ``dst_mask``,
    ``dst_langs``), ``row_mask``, and optionally the negative pools
    (``src_neg``, ``src_neg_mask``, ``src_neg_langs``, ``src_neg_row_mask``
    and the same four ``tgt_neg*``). The metrics count rows: ``sum_loss`` =
    loss * n, ``ntokens`` = n, the real rows (all rows without a
    ``row_mask``); the loss includes the weighted MoE term, as the JAX
    step's metric does. Under the model's mesh the pairs and pools whose
    rows were split are gathered over the data group."""
    mesh = getattr(model, "mesh", None)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                rng: torch.Generator):
        n = _row_count(batch, "src", mesh)
        share, aux = _with_aux(
            model, model, batch["src"], batch["src_mask"], batch["src_langs"],
            batch["dst"], batch["dst_mask"], batch["dst_langs"],
            batch.get("src_neg"), batch.get("src_neg_mask"),
            batch.get("src_neg_langs"), batch.get("tgt_neg"),
            batch.get("tgt_neg_mask"), batch.get("tgt_neg_langs"),
            deterministic=False, rng=rng, row_mask=batch.get("row_mask"),
            src_neg_row_mask=batch.get("src_neg_row_mask"),
            tgt_neg_row_mask=batch.get("tgt_neg_row_mask"),
            data_group=_data_group(model, batch, "src"),
            neg_groups=(_data_group(model, batch, "src_neg"),
                        _data_group(model, batch, "tgt_neg")),
            count=None if mesh is None else n)
        share = _plus(share, aux)
        _descend(state, optimizer, share, mesh)
        return state, {"sum_loss": _global(share, mesh) * n, "ntokens": n}

    return step_fn


def make_caption2image_train_step(model, optimizer: Optimizer) -> Callable:
    """Caption2Image's regression step: the squared error of the pseudo grid
    against ``batch["target_grid"]`` [B, 49, E] (a frozen captioner's
    ``encode_images``, detached, read in fp32), summed over the grid and
    averaged over ``row_mask``, plus the weighted MoE term. ``batch``:
    ``src``, ``src_mask``, ``src_langs``, ``target_grid``, ``row_mask``. The
    metrics count rows, the loss with its MoE term (as the JAX step's).
    Under the model's mesh the average is over the global rows."""
    mesh = getattr(model, "mesh", None)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                rng: torch.Generator):
        grid, aux = _with_aux(model, model, batch["src"], batch["src_mask"],
                              batch["src_langs"], deterministic=False,
                              rng=rng)
        target = batch["target_grid"].detach().to(torch.float32)
        per_row = torch.sum((grid - target) ** 2, dim=(1, 2))
        rm = batch["row_mask"].to(torch.float32)
        n = _global(rm.sum(), mesh)
        share = _plus(torch.sum(per_row * rm) / torch.clamp(n, min=1.0), aux)
        _descend(state, optimizer, share, mesh)
        return state, {"sum_loss": _global(share, mesh) * n, "ntokens": n}

    return step_fn


@dataclasses.dataclass
class CaptionTrainState:
    """The captioner's training state: ``params`` are the model's
    ``named_parameters()`` and ``batch_stats`` the ResNet's BatchNorm
    running statistics (its buffers, moved in place by a step in training
    mode)."""
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: AnyOptState
    step: int


def create_caption_train_state(model, optimizer: Optimizer
                               ) -> CaptionTrainState:
    params = dict(model.named_parameters())
    return CaptionTrainState(params=params,
                             batch_stats=dict(model.named_buffers()),
                             opt_state=optimizer.init(params), step=0)


def _caption_update(state: CaptionTrainState, model, optimizer: Optimizer,
                    logits, targets, mask, label_smoothing: float,
                    weight: float = 1.0, aux=None):
    """The caption-family steps' loss: ``smoothed_nll_loss`` itself, never
    the fused kernels (the JAX steps call it directly, whatever
    ``use_pallas_xent`` says); vocab-parallel where the model splits the
    vocab; global over the model's mesh."""
    tp = getattr(model, "vocab_tp", None)
    if tp is None:
        sum_l, n = smoothed_nll_loss(logits, targets, mask,
                                     epsilon=label_smoothing)
    else:
        sum_l, n = smoothed_nll_loss_vocab_parallel(
            logits, targets, mask, label_smoothing, model.vocab_range()[0],
            model.cfg.vocab_size, tp.model_group)
    return _update(state, optimizer, sum_l, n, weight, aux,
                   getattr(model, "mesh", None))


def _caption_targets(batch):
    """(captions[:, 1:], their loss mask)."""
    return (batch["captions"][:, 1:],
            batch["caption_mask"][:, 1:] & batch["row_mask"][:, None])


def make_caption_train_step(model, optimizer: Optimizer,
                            label_smoothing: float = 0.1,
                            loss_weight: float = 1.0) -> Callable:
    """Captioning step: captions decoded against the image grid, the
    label-smoothed loss on captions[:, 1:] (its gradient scaled by
    ``loss_weight``), the ResNet in training mode (its running statistics
    move). Returns ``step_fn(state, batch, rng) -> (state, metrics)``:
    ``batch`` as ``caption_batch_to_device`` stages it, ``rng`` the host
    torch.Generator of the dropout seeds."""

    def step_fn(state: CaptionTrainState, batch: Dict[str, torch.Tensor],
                rng: torch.Generator):
        logits, aux = _with_aux(
            model, model.caption_forward, batch["images"], batch["captions"],
            batch["caption_mask"], batch["langs"], train=True,
            deterministic=False, rng=rng)
        return _caption_update(state, model, optimizer, logits,
                               *_caption_targets(batch), label_smoothing,
                               loss_weight, aux)

    return step_fn


def make_caption_obj_train_step(model, optimizer: Optimizer,
                                label_smoothing: float = 0.1) -> Callable:
    """Captioning with the object stream: the grid decoder and the object
    decoder blended by the multistream gate. ``batch`` also carries
    ``box_features`` [N, O, F] and ``object_labels`` [N, O] (0: padding)."""

    def step_fn(state: CaptionTrainState, batch: Dict[str, torch.Tensor],
                rng: torch.Generator):
        logits, aux = _with_aux(
            model, model.caption_forward_with_objects, batch["images"],
            batch["box_features"], batch["object_labels"], batch["captions"],
            batch["caption_mask"], batch["langs"], train=True,
            deterministic=False, rng=rng)
        return _caption_update(state, model, optimizer, logits,
                               *_caption_targets(batch), label_smoothing,
                               aux=aux)

    return step_fn


def make_caption_mt_train_step(model, optimizer: Optimizer,
                               mtl_weight: float = 0.1,
                               label_smoothing: float = 0.1) -> Callable:
    """The captioner's MT stream: the MT loss through its text core, scaled
    by ``mtl_weight`` (``--mtlw``); the ResNet and its statistics are not
    touched. ``batch``: ``mt_batch_to_device``'s dict."""

    def step_fn(state: CaptionTrainState, batch: Dict[str, torch.Tensor],
                rng: torch.Generator):
        logits, aux = _with_aux(
            model, model, batch["src"], batch["src_mask"], batch["dst"],
            batch["dst_mask"], batch["src_langs"], batch["dst_langs"],
            deterministic=False, rng=rng)
        mask = batch["dst_mask"][:, 1:] & batch["row_mask"][:, None]
        return _caption_update(state, model, optimizer, logits,
                               batch["dst"][:, 1:], mask, label_smoothing,
                               mtl_weight, aux)

    return step_fn


def make_multimodal_mass_step(model, optimizer: Optimizer, cfg,
                              n_specials: int = 5, mask_id: int = 3,
                              label_smoothing: float = 0.1) -> Callable:
    """MASS over an image batch: a span of each caption corrupted on the
    device, then decoded against both the corrupted caption's encoding and
    the image grid, blended by the multimodal gate; the ResNet in training
    mode (its running statistics move).

    Returns ``step_fn(state, batch, rng, draws=None) -> (state, metrics)``.
    ``batch``: ``caption_batch_to_device``'s dict plus ``lengths`` [B] and
    ``mask_prob`` (drawn per batch from U(mask_prob, 1) by the trainers, a
    float, rounded to float32 where it is used). ``draws``: a ``MassDraws``
    to use in place of drawing (the tests feed the JAX package's draws)."""

    def step_fn(state: CaptionTrainState, batch: Dict[str, torch.Tensor],
                rng: torch.Generator, draws: Optional[MassDraws] = None):
        caps = batch["captions"]
        drop = DropoutRng(rng, caps.device, getattr(model, "mesh", None))
        if draws is None:
            draws = draw_mass(drop.dev, caps, batch["lengths"],
                              batch["mask_prob"], n_specials=n_specials,
                              vocab_size=cfg.vocab_size)
        masked = mass_mask_core(
            draws, caps, batch["lengths"], batch["mask_prob"],
            mask_id=mask_id, pad_id=cfg.pad_id,
            span_width=caps.shape[1] // 2 + 1)
        dec_mask = masked.dec_inputs != cfg.pad_id
        logits, aux = _with_aux(
            model, model.multimodal_mass_forward, batch["images"],
            masked.src, batch["caption_mask"], batch["langs"],
            masked.dec_inputs, dec_mask, masked.positions, train=True,
            deterministic=False, rng=drop)
        mask = dec_mask[:, 1:] & batch["row_mask"][:, None]
        return _caption_update(state, model, optimizer, logits,
                               masked.dec_inputs[:, 1:], mask,
                               label_smoothing, aux=aux)

    return step_fn


def make_text_mass_step_mm(model, optimizer: Optimizer, cfg,
                           mask_prob: float = 0.5, n_specials: int = 5,
                           mask_id: int = 3,
                           label_smoothing: float = 0.1) -> Callable:
    """Text MASS batches of the multimodal trainer: ``make_mass_train_step``
    over the captioner's text core (its forward is the core's), the fused
    cross-entropy under ``use_pallas_xent``; the span never reaches the
    ResNet, so its statistics stay as they are."""
    return make_mass_train_step(model, optimizer, cfg, mask_prob=mask_prob,
                                n_specials=n_specials, mask_id=mask_id,
                                label_smoothing=label_smoothing)


def make_contrastive_step(model, optimizer: Optimizer) -> Callable:
    """Image-text InfoNCE step (``ImageSeq2Seq.contrastive_loss``, the
    ResNet in training mode). ``batch``: ``caption_batch_to_device``'s dict
    plus the text negatives ``neg`` [N, Tn], ``neg_mask`` and ``neg_langs``
    [N]. The metrics count rows: ``sum_loss`` = loss * B, ``ntokens`` = B
    (all B rows, padding included). Under the model's mesh the text vectors
    and the negatives whose rows were split are gathered over the data
    group, and B is the global count."""
    mesh = getattr(model, "mesh", None)

    def step_fn(state: CaptionTrainState, batch: Dict[str, torch.Tensor],
                rng: torch.Generator):
        n = _row_count({"captions": batch["captions"]}, "captions", mesh)
        count = None
        if mesh is not None:
            count = (n if "row_mask" not in batch
                     else _row_count(batch, "captions", mesh))
        share, aux = _with_aux(
            model, model.contrastive_loss, batch["images"],
            batch["captions"], batch["caption_mask"], batch["langs"],
            batch["neg"], batch["neg_mask"], batch["neg_langs"], train=True,
            deterministic=False, row_mask=batch.get("row_mask"), rng=rng,
            data_group=_data_group(model, batch, "captions"),
            neg_group=_data_group(model, batch, "neg"), count=count)
        _descend(state, optimizer, _plus(share, aux), mesh)
        return state, {"sum_loss": _global(share, mesh) * n, "ntokens": n}

    return step_fn


def _to(x, device, rows: slice = slice(None)) -> torch.Tensor:
    """``x[rows]`` (a host array, or a tensor) on ``device``: under a mesh
    a rank copies only its rows (JAX ``put_global``)."""
    return torch.as_tensor(x[rows]).to(device, non_blocking=True)


def mt_batch_to_device(b, device, tgt_positions=None,
                       rows: slice = slice(None)) -> Dict[str, torch.Tensor]:
    """MTBatch (data/loader.py) -> dict of tensors on ``device`` for
    ``make_mt_train_step``; ``rows``: the rows to copy (all by default)."""
    out = {name: _to(getattr(b, name), device, rows)
           for name in ("src", "src_mask", "dst", "dst_mask", "src_langs",
                        "dst_langs", "row_mask")}
    if tgt_positions is not None:
        out["tgt_positions"] = _to(tgt_positions, device, rows)
    if getattr(b, "proposals", None) is not None:
        out["proposals"] = _to(b.proposals, device, rows)
        out["proposal_mask"] = _to(b.proposal_mask, device, rows)
    return out


def packed_mt_batch_to_device(b, device, rows: slice = slice(None)
                              ) -> Dict[str, torch.Tensor]:
    """A packed batch (rows holding several examples: ``src``, ``src_seg``,
    ``src_pos``, ``dst``, ``dst_seg``, ``dst_pos``, ``src_langs``,
    ``dst_langs``) -> dict of tensors; ``make_mt_train_step`` dispatches on
    the ``src_seg`` key."""
    return {name: _to(getattr(b, name), device, rows)
            for name in ("src", "src_seg", "src_pos", "dst", "dst_seg",
                         "dst_pos", "src_langs", "dst_langs")}


def mass_batch_to_device(b, device, rows: slice = slice(None)
                         ) -> Dict[str, torch.Tensor]:
    """MassBatch (data/loader.py) -> dict of tensors on ``device`` for
    ``make_mass_train_step``."""
    return {name: _to(getattr(b, name), device, rows)
            for name in ("src", "src_mask", "langs", "lang_tokens",
                         "lengths", "row_mask")}


def lm_batch_to_device(b: Dict, device, rows: slice = slice(None),
                       cols: slice = slice(None)) -> Dict[str, torch.Tensor]:
    """A ``DocBlockDataset.batches`` dict of numpy arrays -> dict of tensors
    on ``device`` for the MLM steps; only ``rows`` (and of a [B, T] array
    ``cols``) are copied: this rank's share under a mesh."""
    return {name: _to(b[name][:, cols] if b[name].ndim == 2 else b[name],
                      device, rows)
            for name in ("texts", "pad_mask", "langs", "row_mask")}


def caption_batch_to_device(b, images, device, objects=None,
                            rows: slice = slice(None)
                            ) -> Dict[str, torch.Tensor]:
    """A ``CaptionBatch`` (data/images.py) and its images [N, S, S, 3]
    (uint8 or normalised float; a tensor is taken as staged already, its
    rows those of ``rows``) -> dict of tensors on ``device`` for the
    caption steps; ``objects``: (box_features, object_labels) for the object
    step; ``rows``: the rows to copy (all by default)."""
    staged = isinstance(images, torch.Tensor)
    out = {"images": (images.to(device) if staged
                      else _to(images, device, rows)),
           "captions": _to(b.captions, device, rows),
           "caption_mask": _to(b.caption_mask, device, rows),
           "langs": _to(b.langs, device, rows),
           "row_mask": _to(b.row_mask, device, rows)}
    if objects is not None:
        out["box_features"] = _to(objects[0], device, rows)
        out["object_labels"] = _to(objects[1], device, rows)
    return out
