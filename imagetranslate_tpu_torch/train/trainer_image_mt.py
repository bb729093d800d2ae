"""Multimodal MT trainer (port of
imagetranslate_tpu/train/trainer_image_mt.py: ``ImageMTTrainer``, the MASS,
MT and back-translation streams of ``MTTrainer`` plus an image-caption
stream, in one epoch).

The text ``Seq2Seq`` becomes an ``ImageSeq2Seq`` (the text core, the ResNet
grid encoder, the pooling heads and the multimodal gate) and the state a
``CaptionTrainState`` (the BatchNorm statistics). An image batch trains by
``mm_mode``:

- "masked": multimodal MASS, a span of each caption corrupted and decoded
  against the gated blend of the text encoding and the image grid, its span
  rate drawn per batch from U(``mask_prob``, 1);
- "contrastive": image-text InfoNCE against sampled text negatives;
- "mixed": a coin per batch.

The host draws (the coin, the span rate, the negatives) are keyed on the
step counter ``_host_step`` that ``MTTrainer.train_epoch`` sets before each
step. In the fine-tune phase the MASS stream is back-translated while the
image batches keep flowing. MT batches train at full weight (``--mtlw``
belongs to the caption trainer).

Under a mesh the model keeps this rank's shard of the JAX TP rules
(``ImageSeq2Seq.shard_``; the ResNet and its statistics whole), the steps
take this rank's rows of each batch (copied from the host alone) and hold
the global batch semantics, and the back-translation decodes split their
rows over the data group, as in ``MTTrainer``. ``zero=True`` (ZeRO-1,
parallel/zero.py) keeps this rank's slices of the split tensors' Adam
moments over the data group, as the JAX trainer's ``_maybe_zero`` places
them; the numbers are those without it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from imagetranslate_tpu_torch.models.captioning import ImageSeq2Seq
from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.parallel.mesh import host_rows
from imagetranslate_tpu_torch.parallel.zero import ZeroLayout
from imagetranslate_tpu_torch.text.processor import TextProcessor
from imagetranslate_tpu_torch.train.optimizer import build_optimizer
from imagetranslate_tpu_torch.train.step import (
    caption_batch_to_device,
    make_caption_mt_train_step,
    make_contrastive_step,
    make_multimodal_mass_step,
    make_text_mass_step_mm,
    wrap_accum,
)
from imagetranslate_tpu_torch.train.trainer_caption import (
    CaptionVariables,
    add_negatives,
    image_batch_draws,
)
from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer
from imagetranslate_tpu_torch.train.weights import CAPTION

MM_MODES = ("mixed", "masked", "contrastive")


class ImageMTTrainer(CaptionVariables, MTTrainer):
    def __init__(self, cfg: Seq2SeqConfig, tp: TextProcessor,
                 variables=None, lr: float = 1e-4, warmup: int = 4000,
                 clip: float = 1.0, accum: int = 1, mask_prob: float = 0.5,
                 mm_mode: str = "mixed", beam_width: int = 4,
                 bt_beam_width: int = 1, max_len_a: float = 1.1,
                 max_len_b: int = 5, len_penalty_ratio: float = 0.8,
                 label_smoothing: float = 0.1,
                 img_size: Optional[int] = None, mesh=None, seed: int = 0,
                 zero: bool = False, device="cuda"):
        """``variables``: flax-layout ``{"params", "batch_stats"}`` to start
        from (None: random, from ``seed``). ``img_size`` overrides the
        config's, and the config (so every checkpoint) records it.
        ``device``: where the model trains; ``cuda`` fails without a
        card; under a ``mesh`` the mesh's device. ``zero``: ZeRO-1 over
        the mesh's data group."""
        if mm_mode not in MM_MODES:
            raise ValueError(f"mm_mode {mm_mode!r}: one of {MM_MODES}")
        if img_size is not None and img_size != cfg.img_size:
            cfg = dataclasses.replace(cfg, img_size=img_size)
        self.cfg = cfg
        self.img_size = cfg.img_size
        self.tp = tp
        self.device = torch.device(device) if mesh is None else mesh.device
        self.model = ImageSeq2Seq(cfg, device=self.device,
                                  param_dtype=torch.float32)
        self.rng = torch.Generator().manual_seed(seed)  # the dropout seeds
        self.beam_width = beam_width
        self.bt_beam_width = bt_beam_width
        self.max_len_a = max_len_a
        self.max_len_b = max_len_b
        self.len_penalty_ratio = len_penalty_ratio
        self.best_bleu = -1.0
        self.reference: List[str] = []
        self.mm_mode = mm_mode
        self.mask_prob = mask_prob
        self._cur_img_batcher = None
        self._host_step = 0
        self.optimizer = wrap_accum(
            build_optimizer(lr=lr, warmup_updates=warmup, clip_norm=clip),
            accum)
        self._shard_model(mesh)
        if zero and mesh is not None and mesh.n_data > 1:
            self.zero = ZeroLayout(
                {k: p.shape for k, p in self.model.named_parameters()}, mesh,
                cfg, self.plan)
            self.optimizer.set_zero(self.zero)
        specials = dict(n_specials=len(tp.special_tokens),
                        mask_id=tp.mask_token_id(),
                        label_smoothing=label_smoothing)
        self.mt_step = make_caption_mt_train_step(
            self.model, self.optimizer, mtl_weight=1.0,
            label_smoothing=label_smoothing)
        self.mass_step = make_text_mass_step_mm(
            self.model, self.optimizer, cfg, mask_prob=mask_prob, **specials)
        self.mm_mass_step = make_multimodal_mass_step(
            self.model, self.optimizer, cfg, **specials)
        self.contrastive_step = make_contrastive_step(self.model,
                                                      self.optimizer)
        if variables is None:
            variables = CAPTION.random_params(cfg, seed)
        self.set_reference_variables(variables)

    def set_reference_params(self, variables, step: int = 0):
        """``MTTrainer``'s name for it: here the weights are the
        captioner's ``{"params", "batch_stats"}``."""
        self.set_reference_variables(variables, step)

    # ---------------- the image stream ----------------

    def _stage_img(self, b, image_root: str) -> torch.Tensor:
        """Prefetch-thread hook: the batch's images decoded as uint8 and
        copied to the device (the heaviest host work of an image batch)."""
        images = b.images(image_root, size=self.img_size, raw=True)
        rows = host_rows(images.shape[0], self.mesh)
        return torch.as_tensor(images[rows]).to(self.device,
                                                non_blocking=True)

    def _img_step(self, b, image_root: str, rng, images=None):
        if images is None:
            images = self._stage_img(b, image_root)
        rows = host_rows(b.captions.shape[0], self.mesh)
        batch = self._staged(caption_batch_to_device(b, images, self.device,
                                                     rows=rows), rows)
        mode, mask_prob = image_batch_draws(self.mm_mode, self.mask_prob,
                                            self._host_step + 1)
        if mode == "contrastive":
            negs = self._cur_img_batcher.sample_negatives(
                b.captions.shape[0], self._host_step)
            add_negatives(batch, negs, int(b.langs[0]),
                          self.tp.pad_token_id(), self.device, self.mesh)
            self.state, m = self.contrastive_step(self.state, batch, rng)
        else:
            batch["lengths"] = torch.as_tensor(b.lengths[rows]).to(
                self.device)
            batch["mask_prob"] = mask_prob
            self.state, m = self.mm_mass_step(self.state, batch, rng)
        return m
