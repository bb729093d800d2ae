"""Caption -> pseudo image grid regressor (port of
imagetranslate_tpu/models/caption2image.py: ``GRID_SLOTS`` and
``Caption2Image``).

The text encoder and an attention pool give one vector a caption; an fp32
Linear expands it into a 49-slot grid [B, 49, E], which training regresses
onto a frozen captioner's image grid (``train/trainer_txt2image.py``) and
``cli/translate_img.py`` hands the captioner's decoder as encoder states.
"""

from __future__ import annotations

import torch
from torch import nn

from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.seq2seq import AttentionPool
from imagetranslate_tpu_torch.models.sensim import encode_pooled
from imagetranslate_tpu_torch.models.transformer import (
    Encoder,
    dropout_stream,
)

GRID_SLOTS = 49  # the 7 x 7 ResNet grid


class Caption2Image(nn.Module):
    """``param_dtype`` as in ``Seq2Seq`` for the encoder and the pool; the
    grid head ``decoder`` is stored and computed in fp32 whatever the
    config (the flax Dense without a dtype, on the pooled vector cast to
    fp32)."""

    def __init__(self, cfg: Seq2SeqConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        E = cfg.hidden_size
        self.encoder = Encoder(cfg, device, param_dtype)
        self.input_attention = AttentionPool(cfg, device, param_dtype)
        self.decoder = nn.Linear(E, GRID_SLOTS * E, device=device,
                                 dtype=torch.float32)

    def forward(self, src_ids, src_mask, src_langs,
                deterministic: bool = True, rng=None):
        """-> the pseudo grid [B, 49, E], fp32. ``rng`` feeds the dropout
        when ``deterministic`` is False."""
        drop = dropout_stream(deterministic, rng, src_ids.device)
        pooled = encode_pooled(self, src_ids, src_mask, src_langs, drop)
        grid = self.decoder(pooled.to(torch.float32))
        return grid.reshape(src_ids.shape[0], GRID_SLOTS,
                            self.cfg.hidden_size)
