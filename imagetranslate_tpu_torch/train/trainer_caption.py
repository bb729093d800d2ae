"""Image-captioning trainer (port of
imagetranslate_tpu/train/trainer_caption.py: ``CaptionTrainer`` with the
caption stream, the object stream and the ``--mtlw``-weighted MT stream,
grafting an MT model into the text core, multi-reference caption BLEU and
two-slot checkpoints).

- each tick takes one batch from every stream (caption, then MT; the epoch
  ends at the shortest), batches shuffled per epoch; a prefetch thread
  decodes a caption batch's images as uint8, looks up its detections and
  stages it onto the device while the previous step runs;
- a caption batch trains the grid decoder (``make_caption_train_step``), or
  with an ``ObjectStore`` the grid + object decoders
  (``make_caption_obj_train_step``); the ResNet trains in batch-statistics
  mode and its running statistics move;
- with ``mm_mode`` a caption batch trains a multimodal stream instead:
  "masked" (multimodal MASS, its span rate drawn per batch from
  U(``mask_prob``, 1)), "contrastive" (InfoNCE against sampled text
  negatives) or "mixed" (a coin per batch); the host draws are keyed on the
  step counter (``image_batch_draws``);
- telemetry every ``log_every`` steps through ``AsyncStepMeter``, caption
  BLEU every ``eval_every``, a rolling ``.latest`` checkpoint every
  ``save_every`` and at epoch end, the best-BLEU checkpoint in the model
  directory itself.

The model holds fp32 master parameters and computes in ``cfg.dtype``. The
dev decode runs on the same model: each weight is cast to the compute dtype
where it is used, so under a bf16 config the projection + top-k kernel and
(with ``decode_attention_impl="fused"``) the decode attention kernel launch.
One device: a mesh is refused (ROADMAP module 14).
"""

from __future__ import annotations

import dataclasses
import os
import random
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from imagetranslate_tpu_torch.data.images import (
    CaptionBatcher,
    CaptionEvalSet,
)
from imagetranslate_tpu_torch.data.loader import MTBatcher
from imagetranslate_tpu_torch.decoding.beam import (
    beam_search,
    beam_search_dual,
    trim_outputs,
)
from imagetranslate_tpu_torch.models.captioning import (
    OBJECT_FEAT_DIM,
    ImageSeq2Seq,
)
from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.text.processor import TextProcessor
from imagetranslate_tpu_torch.train.checkpoint import save_checkpoint
from imagetranslate_tpu_torch.train.optimizer import (
    build_optimizer,
    set_schedule_step,
)
from imagetranslate_tpu_torch.train.step import (
    caption_batch_to_device,
    create_caption_train_state,
    make_caption_mt_train_step,
    make_caption_obj_train_step,
    make_caption_train_step,
    make_contrastive_step,
    make_multimodal_mass_step,
    mt_batch_to_device,
    wrap_accum,
)
from imagetranslate_tpu_torch.train.weights import (
    CAPTION,
    CAPTION_PARAMS,
    flax_from_opt_state,
    state_dict_from_flax,
)


def image_batch_draws(mm_mode: str, mask_prob: float, key: int
                      ) -> Tuple[str, Optional[float]]:
    """The host draws of one multimodal image batch, from
    ``random.Random(0x9E3779B9 ^ key)`` (``key``: the trainer's step
    counter, so that every process of a run draws the same): the mode ("mixed"
    flips a coin between "masked" and "contrastive") and, for "masked", the
    span rate drawn from U(``mask_prob``, 1), rounded to float32 as the JAX
    trainers send it."""
    host_rnd = random.Random(0x9E3779B9 ^ key)
    mode = mm_mode
    if mode == "mixed":
        mode = "masked" if host_rnd.random() <= 0.5 else "contrastive"
    if mode != "masked":
        return mode, None
    return mode, float(np.float32(host_rnd.uniform(mask_prob, 1.0)))


def add_negatives(batch: Dict[str, torch.Tensor], negs: np.ndarray,
                  lang: int, pad_id: int, device) -> None:
    """The contrastive step's text negatives, in the batch's language."""
    batch["neg"] = torch.as_tensor(negs).to(device)
    batch["neg_mask"] = batch["neg"] != pad_id
    batch["neg_langs"] = torch.full((negs.shape[0],), lang,
                                    dtype=torch.int32, device=device)


class CaptionVariables:
    """The weights of a trainer of an ``ImageSeq2Seq`` held as fp32 masters
    in ``self.model``: flax-layout ``{"params", "batch_stats"}`` in and out,
    an MT model grafted into the text core, checkpoints with the Adam
    state."""

    def set_reference_variables(self, variables, step: int = 0):
        """Replace the weights and the BatchNorm statistics from a
        flax-layout ``{"params", "batch_stats"}`` tree and reset the
        optimizer state to match; ``step`` re-seats the LR schedule."""
        self.model.load_state_dict(
            CAPTION.state_dict_from_flax(variables, self.cfg), strict=True)
        self.state = create_caption_train_state(self.model, self.optimizer)
        if step:
            set_schedule_step(self.state.opt_state, step)

    def graft_mt_model(self, mt_params):
        """Copy a pretrained ``Seq2Seq`` parameter tree (``{"params": ...}``
        or the inner dict) into the text core, in place: the optimizer state
        is kept."""
        self.model.core.load_state_dict(
            state_dict_from_flax(mt_params, self.cfg), strict=True)

    def variables(self) -> dict:
        """The fp32 masters and the running statistics as the flax-layout
        ``{"params", "batch_stats"}``."""
        return CAPTION.flax_from_state_dict(self.model.state_dict(),
                                            self.cfg)

    def _save(self, path: str, step: int):
        save_checkpoint(
            path, self.cfg, self.variables(),
            opt_state=flax_from_opt_state(self.state.opt_state,
                                          self.optimizer, self.cfg,
                                          CAPTION_PARAMS),
            step=step, best_metric=self.best_bleu)


class CaptionTrainer(CaptionVariables):
    def __init__(self, cfg: Seq2SeqConfig, tp: TextProcessor,
                 variables=None, lr: float = 1e-4, warmup: int = 4000,
                 clip: float = 1.0, accum: int = 1, beam_width: int = 4,
                 len_penalty_ratio: float = 0.8, mtl_weight: float = 0.1,
                 label_smoothing: float = 0.1, mm_mode: Optional[str] = None,
                 mask_prob: float = 0.5, img_size: Optional[int] = None,
                 mesh=None, seed: int = 0,
                 object_feat_dim: int = OBJECT_FEAT_DIM, device="cuda"):
        """``variables``: flax-layout ``{"params", "batch_stats"}`` to start
        from (None: random, from ``seed``). ``mm_mode``: None (captioning),
        "masked", "contrastive" or "mixed" (the multimodal image streams);
        ``mask_prob`` is the floor of their span rate. ``img_size``
        overrides the config's, and the config (so every checkpoint) records
        it. ``device``: where the model trains; ``cuda`` fails without a
        card."""
        if mesh is not None:
            raise NotImplementedError("a mesh: multi-device training is not "
                                      "ported yet (ROADMAP module 14)")
        if img_size is not None and img_size != cfg.img_size:
            cfg = dataclasses.replace(cfg, img_size=img_size)
        self.cfg = cfg
        self.img_size = cfg.img_size
        self.tp = tp
        self.device = torch.device(device)
        self.model = ImageSeq2Seq(cfg, device=self.device,
                                  param_dtype=torch.float32,
                                  object_feat_dim=object_feat_dim)
        self.rng = torch.Generator().manual_seed(seed)  # the dropout seeds
        self.beam_width = beam_width
        self.len_penalty_ratio = len_penalty_ratio
        self.best_bleu = -1.0
        self.caption_reference: Dict[int, List[str]] = defaultdict(list)
        self.optimizer = wrap_accum(
            build_optimizer(lr=lr, warmup_updates=warmup, clip_norm=clip),
            accum)
        self.cap_step = make_caption_train_step(
            self.model, self.optimizer, label_smoothing=label_smoothing)
        if cfg.use_obj:
            self.cap_obj_step = make_caption_obj_train_step(
                self.model, self.optimizer, label_smoothing=label_smoothing)
        self.mt_step = make_caption_mt_train_step(
            self.model, self.optimizer, mtl_weight=mtl_weight,
            label_smoothing=label_smoothing)
        self.mm_mode = mm_mode
        self.mask_prob = mask_prob
        if mm_mode is not None:
            self.mm_mass_step = make_multimodal_mass_step(
                self.model, self.optimizer, cfg,
                n_specials=len(tp.special_tokens),
                mask_id=tp.mask_token_id(), label_smoothing=label_smoothing)
            self.contrastive_step = make_contrastive_step(self.model,
                                                          self.optimizer)
        if variables is None:
            variables = CAPTION.random_params(cfg, seed, object_feat_dim)
        self.set_reference_variables(variables)

    # ---------------- training ----------------

    def train_epoch(self, step: int, saving_path: str,
                    cap_batcher: CaptionBatcher, image_root: str = "",
                    mt_batcher: Optional[MTBatcher] = None,
                    eval_set: Optional[CaptionEvalSet] = None,
                    obj_store=None, max_step: int = 300_000,
                    eval_every: int = 5000, save_every: int = 10_000,
                    epoch_seed: int = 0, log_every: int = 50) -> int:
        from imagetranslate_tpu_torch.data.prefetch import PrefetchIterator
        from imagetranslate_tpu_torch.utils.metrics import AsyncStepMeter

        if obj_store is not None and not self.cfg.use_obj:
            raise ValueError("an ObjectStore trains the object stream, which "
                             "this model's config leaves out (use_obj)")
        streams = [("cap", cap_batcher.shuffled(epoch_seed))]
        if mt_batcher is not None:
            streams.append(("mt", mt_batcher.shuffled(epoch_seed)))

        def interleaved():
            # One batch from every stream per tick; the shortest stream ends
            # the epoch (and drops the tick it ends in).
            while True:
                tick = []
                try:
                    for kind, it in streams:
                        tick.append((kind, next(it)))
                except StopIteration:
                    return
                yield from tick

        # The object step runs when mm_mode routes to neither multimodal
        # step ("mixed" picks between those two only).
        stage_objs = (obj_store is not None and self.mm_mode not in
                      ("masked", "contrastive", "mixed"))

        def stage(item):
            # Runs in the prefetch thread: image decode, the detections'
            # lookup and the copy to the device of batch N+1 overlap the
            # step on batch N.
            kind, b = item
            if kind == "mt":
                return kind, b, mt_batch_to_device(b, self.device)
            images = b.images(image_root, size=self.img_size, raw=True)
            objects = None
            if stage_objs:
                objects = obj_store.lookup(b.image_paths,
                                           b.captions.shape[0])
            batch = caption_batch_to_device(b, images, self.device, objects)
            if self.mm_mode is not None:
                batch["lengths"] = torch.as_tensor(b.lengths).to(self.device)
            return kind, b, batch

        meter = AsyncStepMeter(log_every=log_every)
        prefetcher = PrefetchIterator(interleaved(), stage, depth=3)
        try:
            for kind, b, batch in prefetcher:
                mode, mask_prob = (
                    image_batch_draws(self.mm_mode, self.mask_prob, step + 1)
                    if kind == "cap" else (None, None))
                if kind == "mt":
                    self.state, m = self.mt_step(self.state, batch, self.rng)
                elif mode == "masked":
                    batch["mask_prob"] = mask_prob
                    self.state, m = self.mm_mass_step(self.state, batch,
                                                      self.rng)
                elif mode == "contrastive":
                    add_negatives(batch, cap_batcher.sample_negatives(
                        b.captions.shape[0], step + 1), int(b.langs[0]),
                        self.tp.pad_token_id(), self.device)
                    self.state, m = self.contrastive_step(self.state, batch,
                                                          self.rng)
                elif stage_objs:
                    self.state, m = self.cap_obj_step(self.state, batch,
                                                      self.rng)
                else:
                    self.state, m = self.cap_step(self.state, batch,
                                                  self.rng)
                step += 1
                # Device scalars: the meter syncs once per log window.
                meter.update(step, m["sum_loss"], m["ntokens"])
                if eval_set is not None and step % eval_every == 0:
                    bleu = self.eval_caption_bleu(eval_set, image_root,
                                                  saving_path,
                                                  obj_store=obj_store)
                    print(f"Captioning BLEU: {bleu:.2f}", flush=True)
                if step % save_every == 0:
                    self._save(saving_path + ".latest", step)
                if step >= max_step:
                    break
        finally:
            prefetcher.close()

        meter.finish(step)
        print(f"Total loss in this epoch: {meter.epoch_loss():.4f}",
              flush=True)
        self._save(saving_path + ".latest", step)
        if eval_set is not None:
            bleu = self.eval_caption_bleu(eval_set, image_root, saving_path,
                                          obj_store=obj_store)
            print(f"Captioning BLEU: {bleu:.2f}", flush=True)
        return step

    # ---------------- evaluation ----------------

    @torch.no_grad()
    def caption_images(self, images: np.ndarray, first_tokens: np.ndarray,
                       tgt_langs: np.ndarray, max_len: int,
                       beam_width: Optional[int] = None,
                       box_features: Optional[np.ndarray] = None,
                       object_labels: Optional[np.ndarray] = None):
        """Beam-decode captions of a batch of images (uint8 or normalised)
        -> (tokens [N, max_len], lengths [N]) on the device; with
        ``box_features``/``object_labels`` the grid + object decode."""
        def dev(a):
            return torch.as_tensor(np.asarray(a)).to(self.device)

        grid = self.model.encode_images(dev(images))
        img_mask = torch.ones(grid.shape[:2], dtype=torch.bool,
                              device=self.device)
        common = dict(beam_width=beam_width or self.beam_width,
                      max_len=max_len,
                      len_penalty_ratio=self.len_penalty_ratio,
                      pad_id=self.tp.pad_token_id(),
                      eos_id=self.tp.sep_token_id())
        if box_features is not None:
            obj_states, obj_keep = self.model.encode_objects(
                dev(box_features), dev(object_labels))
            return beam_search_dual(
                self.model, grid, img_mask, obj_states, dev(first_tokens),
                dev(tgt_langs), None, grid_mask=obj_keep,
                init_method=ImageSeq2Seq.init_obj_dual_cache,
                step_method=ImageSeq2Seq.decode_step_obj_dual, **common)
        return beam_search(self.model, grid, img_mask, dev(first_tokens),
                           dev(tgt_langs), None, **common)

    def _build_reference(self, eval_set: CaptionEvalSet):
        self.caption_reference = defaultdict(list)
        for g in eval_set.groups:
            for ref in g.references:
                ids = [t for t in ref if t != self.tp.pad_token_id()][1:]
                if ids and ids[-1] == self.tp.sep_token_id():
                    ids = ids[:-1]
                self.caption_reference[g.image_id].append(self.tp.decode(ids))

    def eval_caption_bleu(self, eval_set: CaptionEvalSet, image_root: str,
                          saving_path: str, obj_store=None) -> float:
        """Multi-reference caption BLEU (sacrebleu, lowercase, "intl"
        tokenization) with ``bleu.caption.output`` /
        ``bleu.caption.best.output`` transcripts; a better score saves the
        model into ``saving_path``."""
        import sacrebleu

        from imagetranslate_tpu_torch.data.prefetch import default_image_pool

        if not self.caption_reference:
            self._build_reference(eval_set)
        outputs, ids = [], []
        # The decode length padded to a multiple of 16.
        L = max(16, ((eval_set.max_len + 15) // 16) * 16)
        for group in eval_set.batches():
            paths = [g.image_path for g in group]
            images = default_image_pool().decode(paths, root=image_root,
                                                 size=self.img_size, raw=True)
            first = np.array([g.first_token for g in group], np.int32)
            langs = np.full((len(group),), eval_set.lang, np.int32)
            feats = labels = None
            if obj_store is not None:
                feats, labels = obj_store.lookup(paths, len(group))
            best, lengths = self.caption_images(images, first, langs, L,
                                                box_features=feats,
                                                object_labels=labels)
            outs = trim_outputs(best, lengths, remove_first_token=True)
            for g, o in zip(group, outs):
                outputs.append(self.tp.decode(o))
                ids.append(g.image_id)

        references = [self.caption_reference[i] for i in ids]
        max_reflen = max(len(r) for r in references)
        all_refs = [[r[n] if n < len(r) else None for r in references]
                    for n in range(max_reflen)]
        bleu = sacrebleu.corpus_bleu(outputs, all_refs, lowercase=True,
                                     tokenize="intl")
        os.makedirs(saving_path, exist_ok=True)
        transcript = "\n".join(
            "\nOutput:\n" + o + "\n\nReferences:\n"
            + "\n".join(self.caption_reference[ids[i]])
            + "\n\n***************\n"
            for i, o in enumerate(outputs))
        with open(os.path.join(saving_path, "bleu.caption.output"), "w") as w:
            w.write(transcript)
        if bleu.score > self.best_bleu:
            self.best_bleu = bleu.score
            print(f"Saving best BLEU {self.best_bleu:.2f}", flush=True)
            with open(os.path.join(saving_path, "bleu.caption.best.output"),
                      "w") as w:
                w.write(transcript)
            self._save(saving_path, self.state.step)
        return bleu.score
