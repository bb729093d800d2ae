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
from imagetranslate_tpu_torch.parallel.comm import all_reduce_sum
from imagetranslate_tpu_torch.train.optimizer import (
    AnyOptState,
    MultiSteps,
    Optimizer,
)


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


def _descend(state, optimizer: Optimizer, objective, mesh=None) -> None:
    """Backward of the scalar ``objective``, then ``apply_grads``."""
    params = list(state.params.values())
    grads = torch.autograd.grad(objective, params, allow_unused=True)
    # A parameter the batch did not reach (another language's decoder)
    # gets a zero gradient, as jax.grad gives it.
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    apply_grads(state, optimizer, grads, mesh)


def apply_grads(state, optimizer: Optimizer, grads, mesh=None) -> None:
    """The gradients (one per ``state.params`` entry, this rank's) summed
    over the mesh's data group, the optimizer update in place. Under ZeRO-1
    (``optimizer.zero``) the split parameters' gradients are
    reduce-scattered instead, and the update all-gathers their slices."""
    if mesh is not None and mesh.data_group is not None:
        zero = getattr(optimizer, "zero", None)
        if zero is not None:
            grads = zero.reduce_grads(grads, list(state.params))
        else:
            flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]),
                                  mesh.data_group)
            grads = [f.view_as(g) for f, g in
                     zip(flat.split([g.numel() for g in grads]), grads)]
    optimizer.update(grads, state.opt_state, state.params)
    state.step += 1


def _update(state, optimizer: Optimizer, sum_l, n, weight: float = 1.0,
            aux=None, mesh=None):
    """Backward of weight * sum_l / n (+ ``aux``, the weighted MoE term),
    the optimizer update in place, the metrics (the unweighted sum). Under
    ``mesh`` n is the data group's count (at least 1) and the metrics the
    group's sums."""
    if mesh is not None and mesh.data_group is not None:
        n = all_reduce_sum(n.detach().clone(), mesh.data_group)
    n = torch.clamp(n, min=1.0)
    _descend(state, optimizer, _plus(weight * sum_l / n, aux), mesh)
    sum_l = sum_l.detach()
    if mesh is not None and mesh.data_group is not None:
        sum_l = all_reduce_sum(sum_l.clone(), mesh.data_group)
    return state, {"sum_loss": sum_l, "ntokens": n}


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

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                rng: torch.Generator):
        packed = "src_seg" in batch
        if packed:
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
        logits, aux = _with_aux(
            model, model, masked.src, batch["src_mask"], masked.dec_inputs,
            dec_mask, batch["langs"], batch["langs"],
            tgt_positions=masked.positions, deterministic=False, rng=drop)
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


def make_mlm_train_step(model, optimizer: Optimizer, cfg,
                        mask_prob: float = 0.15, n_specials: int = 5,
                        mask_id: int = 3) -> Callable:
    """MLM step: 80/10/10 corruption on the device, then plain NLL at the
    masked positions.

    Masked-budget projection: the loss reads only about ``mask_prob`` of the
    positions, while projecting every position stores [B * T, V] fp32 logits.
    From B * T >= 8192 the step gathers a fixed budget of positions (the
    masked ones first, in index order; ``mlm_budget``) and projects only
    those. A masked count above the budget (a many-sigma event at that size)
    drops the masked positions of the highest indices, as the JAX step does.
    Smaller batches project every position.

    Returns ``step_fn(state, batch, rng, draws=None) -> (state, metrics)``.
    ``batch``: ``lm_batch_to_device``'s dict (texts [B, T], pad_mask, langs,
    row_mask). ``rng``: the host torch.Generator; it seeds the device
    generator that the mask draws and the dropout masks come from. ``draws``:
    an ``MLMDraws`` to use in place of drawing (the tests feed the JAX
    package's draws)."""

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                rng: torch.Generator, draws: Optional[MLMDraws] = None):
        texts = batch["texts"]
        drop = DropoutRng(rng, texts.device)
        if draws is None:
            draws = draw_mlm(drop.dev, texts, n_specials=n_specials,
                             vocab_size=cfg.vocab_size)
        masked = mask_text_core(draws, texts, batch["pad_mask"], mask_prob,
                                mask_id=mask_id, eos_id=cfg.eos_id)
        mask = masked.target_mask & batch["row_mask"][:, None]
        B, T = texts.shape
        if B * T >= MLM_BUDGET_MIN_TOKENS:
            h, aux = _with_aux(model, model.encode, masked.texts,
                               batch["pad_mask"], batch["langs"],
                               deterministic=False, rng=drop)
            flat = mask.reshape(-1)
            # A stable descending sort of the 0/1 vector: the masked positions
            # first, each group in index order (what top_k gives in JAX;
            # torch.topk promises no order among equals).
            order = torch.argsort(flat.to(torch.int8), descending=True,
                                  stable=True)[:mlm_budget(B * T, mask_prob)]
            logits = model.project_hidden(h.reshape(B * T, -1)[order])
            sum_l, n = nll_loss(logits, texts.reshape(-1)[order], flat[order])
        else:
            logits, aux = _with_aux(model, model, masked.texts,
                                    batch["pad_mask"], batch["langs"],
                                    deterministic=False, rng=drop)
            sum_l, n = nll_loss(logits, texts, mask)
        return _update(state, optimizer, sum_l, torch.clamp(n, min=1.0),
                       aux=aux)

    return step_fn


def make_mlm_eval_step(model, cfg, mask_prob: float = 0.15,
                       n_specials: int = 5, mask_id: int = 3) -> Callable:
    """Dev loss of the MLM. Returns ``eval_fn(batch, gen, draws=None) ->
    (sum_loss, count)``: ``gen`` is a generator on the batch's device that
    the mask draws come from; the model runs deterministically on all
    positions, without gradients."""

    @torch.no_grad()
    def eval_fn(batch: Dict[str, torch.Tensor], gen: Optional[torch.Generator],
                draws: Optional[MLMDraws] = None):
        texts = batch["texts"]
        if draws is None:
            draws = draw_mlm(gen, texts, n_specials=n_specials,
                             vocab_size=cfg.vocab_size)
        masked = mask_text_core(draws, texts, batch["pad_mask"], mask_prob,
                                mask_id=mask_id, eos_id=cfg.eos_id)
        logits = model(masked.texts, batch["pad_mask"], batch["langs"])
        mask = masked.target_mask & batch["row_mask"][:, None]
        return nll_loss(logits, texts, mask)

    return eval_fn


def make_sensim_train_step(model, optimizer: Optimizer) -> Callable:
    """SenSim's InfoNCE step (``SenSim.forward``). ``batch``: the pair
    (``src``, ``src_mask``, ``src_langs``, ``dst``, ``dst_mask``,
    ``dst_langs``), ``row_mask``, and optionally the negative pools
    (``src_neg``, ``src_neg_mask``, ``src_neg_langs``, ``src_neg_row_mask``
    and the same four ``tgt_neg*``). The metrics count rows: ``sum_loss`` =
    loss * n, ``ntokens`` = n, the real rows (all rows without a
    ``row_mask``); the loss includes the weighted MoE term, as the JAX
    step's metric does."""

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                rng: torch.Generator):
        loss, aux = _with_aux(
            model, model, batch["src"], batch["src_mask"], batch["src_langs"],
            batch["dst"], batch["dst_mask"], batch["dst_langs"],
            batch.get("src_neg"), batch.get("src_neg_mask"),
            batch.get("src_neg_langs"), batch.get("tgt_neg"),
            batch.get("tgt_neg_mask"), batch.get("tgt_neg_langs"),
            deterministic=False, rng=rng, row_mask=batch.get("row_mask"),
            src_neg_row_mask=batch.get("src_neg_row_mask"),
            tgt_neg_row_mask=batch.get("tgt_neg_row_mask"))
        loss = _plus(loss, aux)
        _descend(state, optimizer, loss)
        if "row_mask" in batch:
            n = batch["row_mask"].to(torch.float32).sum()
        else:
            n = torch.tensor(float(batch["src"].shape[0]),
                             device=loss.device)
        return state, {"sum_loss": loss.detach() * n, "ntokens": n}

    return step_fn


def make_caption2image_train_step(model, optimizer: Optimizer) -> Callable:
    """Caption2Image's regression step: the squared error of the pseudo grid
    against ``batch["target_grid"]`` [B, 49, E] (a frozen captioner's
    ``encode_images``, detached, read in fp32), summed over the grid and
    averaged over ``row_mask``, plus the weighted MoE term. ``batch``:
    ``src``, ``src_mask``, ``src_langs``, ``target_grid``, ``row_mask``. The
    metrics count rows, the loss with its MoE term (as the JAX step's)."""

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                rng: torch.Generator):
        grid, aux = _with_aux(model, model, batch["src"], batch["src_mask"],
                              batch["src_langs"], deterministic=False,
                              rng=rng)
        target = batch["target_grid"].detach().to(torch.float32)
        per_row = torch.sum((grid - target) ** 2, dim=(1, 2))
        rm = batch["row_mask"].to(torch.float32)
        loss = _plus(torch.sum(per_row * rm)
                     / torch.clamp(torch.sum(rm), min=1.0), aux)
        _descend(state, optimizer, loss)
        n = rm.sum()
        return state, {"sum_loss": loss.detach() * n, "ntokens": n}

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


def _caption_update(state: CaptionTrainState, optimizer: Optimizer, logits,
                    targets, mask, label_smoothing: float,
                    weight: float = 1.0, aux=None):
    """The caption-family steps' loss: ``smoothed_nll_loss`` itself, never
    the fused kernels (the JAX steps call it directly, whatever
    ``use_pallas_xent`` says)."""
    sum_l, n = smoothed_nll_loss(logits, targets, mask,
                                 epsilon=label_smoothing)
    return _update(state, optimizer, sum_l, torch.clamp(n, min=1.0), weight,
                   aux)


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
        return _caption_update(state, optimizer, logits,
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
        return _caption_update(state, optimizer, logits,
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
        sum_l, n = smoothed_nll_loss(logits, batch["dst"][:, 1:], mask,
                                     epsilon=label_smoothing)
        return _update(state, optimizer, sum_l, torch.clamp(n, min=1.0),
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
        drop = DropoutRng(rng, caps.device)
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
        return _caption_update(state, optimizer, logits,
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
    (all B rows, padding included)."""

    def step_fn(state: CaptionTrainState, batch: Dict[str, torch.Tensor],
                rng: torch.Generator):
        loss, aux = _with_aux(
            model, model.contrastive_loss, batch["images"],
            batch["captions"], batch["caption_mask"], batch["langs"],
            batch["neg"], batch["neg_mask"], batch["neg_langs"], train=True,
            deterministic=False, row_mask=batch.get("row_mask"), rng=rng)
        _descend(state, optimizer, _plus(loss, aux))
        n = torch.tensor(float(batch["captions"].shape[0]),
                         device=loss.device)
        return state, {"sum_loss": loss.detach() * n, "ntokens": n}

    return step_fn


def _to(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device, non_blocking=True)


def mt_batch_to_device(b, device, tgt_positions=None) -> Dict[str,
                                                              torch.Tensor]:
    """MTBatch (data/loader.py) -> dict of tensors on ``device`` for
    ``make_mt_train_step``."""
    out = {
        "src": _to(b.src, device), "src_mask": _to(b.src_mask, device),
        "dst": _to(b.dst, device), "dst_mask": _to(b.dst_mask, device),
        "src_langs": _to(b.src_langs, device),
        "dst_langs": _to(b.dst_langs, device),
        "row_mask": _to(b.row_mask, device),
    }
    if tgt_positions is not None:
        out["tgt_positions"] = _to(tgt_positions, device)
    if getattr(b, "proposals", None) is not None:
        out["proposals"] = _to(b.proposals, device)
        out["proposal_mask"] = _to(b.proposal_mask, device)
    return out


def packed_mt_batch_to_device(b, device) -> Dict[str, torch.Tensor]:
    """A packed batch (rows holding several examples: ``src``, ``src_seg``,
    ``src_pos``, ``dst``, ``dst_seg``, ``dst_pos``, ``src_langs``,
    ``dst_langs``) -> dict of tensors; ``make_mt_train_step`` dispatches on
    the ``src_seg`` key."""
    return {name: _to(getattr(b, name), device)
            for name in ("src", "src_seg", "src_pos", "dst", "dst_seg",
                         "dst_pos", "src_langs", "dst_langs")}


def mass_batch_to_device(b, device) -> Dict[str, torch.Tensor]:
    """MassBatch (data/loader.py) -> dict of tensors on ``device`` for
    ``make_mass_train_step``."""
    return {name: _to(getattr(b, name), device)
            for name in ("src", "src_mask", "langs", "lang_tokens",
                         "lengths", "row_mask")}


def lm_batch_to_device(b: Dict, device) -> Dict[str, torch.Tensor]:
    """A ``DocBlockDataset.batches`` dict of numpy arrays -> dict of tensors
    on ``device`` for the MLM steps."""
    return {name: _to(b[name], device)
            for name in ("texts", "pad_mask", "langs", "row_mask")}


def caption_batch_to_device(b, images, device, objects=None
                            ) -> Dict[str, torch.Tensor]:
    """A ``CaptionBatch`` (data/images.py) and its images [N, S, S, 3]
    (uint8 or normalised float) -> dict of tensors on ``device`` for the
    caption steps; ``objects``: (box_features, object_labels) for the object
    step."""
    out = {"images": _to(images, device),
           "captions": _to(b.captions, device),
           "caption_mask": _to(b.caption_mask, device),
           "langs": _to(b.langs, device),
           "row_mask": _to(b.row_mask, device)}
    if objects is not None:
        out["box_features"] = _to(objects[0], device)
        out["object_labels"] = _to(objects[1], device)
    return out
