"""Long-document LM trainer, the ``--reformer`` path of the LM CLI (port of
imagetranslate_tpu/train/trainer_longdoc.py): ``LMTrainer`` over the
local-block-attention ``LongDocLM``. Sequence parallelism over a mesh is not
ported (ROADMAP module 14b)."""

from __future__ import annotations

import dataclasses

import torch

from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.longdoc import LongDocLM, longdoc_config
from imagetranslate_tpu_torch.train import weights
from imagetranslate_tpu_torch.train.trainer_lm import LMTrainer


class LongDocTrainer(LMTrainer):
    bridge = weights.LONGDOC

    def build_model(self, cfg: Seq2SeqConfig):
        return LongDocLM(cfg, device=self.device, param_dtype=torch.float32)

    @classmethod
    def from_options(cls, options, tp, mesh=None, device="cuda"):
        """The trainer ``cli.train_lm --reformer`` builds: the preset
        ``options.model_size`` at the tokenizer's vocabulary, with the
        options' dropout, dtype, learning rate, warmup, clip and mask
        probability."""
        cfg = dataclasses.replace(
            longdoc_config(tp.vocab_size(),
                           num_languages=max(1, len(tp.languages)),
                           size=options.model_size),
            dropout=options.dropout, attention_dropout=options.dropout,
            dtype=options.dtype)
        return cls(cfg, tp, lr=options.learning_rate, warmup=options.warmup,
                   clip=options.clip, mask_prob=options.mask_prob, mesh=mesh,
                   device=device)
