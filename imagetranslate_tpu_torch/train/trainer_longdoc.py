"""Long-document LM trainer, the ``--reformer`` path of the LM CLI (port of
imagetranslate_tpu/train/trainer_longdoc.py): ``LMTrainer`` over the
local-block-attention ``LongDocLM``.

Under a mesh whose model axis is greater than 1 the model axis splits the
SEQUENCE (JAX ``seq_sharding``, context parallelism): rank (d, m) stages the
rows of d and the m-th run of whole blocks of each (``seq_range``), the
parameters stay whole on every rank, and their gradients are summed over
both groups. Under a mesh of model axis 1 it is data parallelism.
"""

from __future__ import annotations

import dataclasses

import torch

from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.longdoc import LongDocLM, longdoc_config
from imagetranslate_tpu_torch.parallel.mesh import ProcessMesh, seq_range
from imagetranslate_tpu_torch.train import weights
from imagetranslate_tpu_torch.train.trainer_lm import LMTrainer


class LongDocTrainer(LMTrainer):
    bridge = weights.LONGDOC

    def build_model(self, cfg: Seq2SeqConfig):
        return LongDocLM(cfg, seq_sharding=self.mesh, device=self.device,
                         param_dtype=torch.float32)

    def shard_model(self, mesh: ProcessMesh):
        """Nothing to split: the parameters are whole on every rank."""
        return {}

    def _cols(self, seq_len: int) -> slice:
        if not self.model.seq_parallel:
            return slice(None)
        return slice(*seq_range(self.mesh, seq_len, self.model.block))

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
