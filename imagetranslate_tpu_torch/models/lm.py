"""Masked language model (port of imagetranslate_tpu/models/lm.py): the BERT
encoder with an output head tied to the word embeddings plus a free bias.

The full [B, T, V] logits come back and the train step masks the loss;
``encode`` / ``project_hidden`` are the split the step's masked-budget
projection uses. The encoder is the ``Encoder`` module of the translation
model under the same name, so the ``encoder.*`` keys of the two
``state_dict``s are the same: warm-starting a translation model from an LM
(``cli.train_mt --lm``) copies that sub-tree.
"""

from __future__ import annotations

import torch
from torch import nn

from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.seq2seq import expand_langs
from imagetranslate_tpu_torch.models.transformer import (
    Encoder,
    dropout_stream,
    pad_bias,
)


class LM(nn.Module):
    """``param_dtype``: the dtype the Linear and Embedding weights are stored
    in (None: the compute dtype; ``torch.float32``: fp32 masters for
    training)."""

    def __init__(self, cfg: Seq2SeqConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, device, param_dtype)
        self.out_bias = nn.Parameter(torch.zeros(
            cfg.vocab_size, dtype=torch.float32, device=device))

    def encode(self, texts, pad_mask, langs, deterministic: bool = True,
               rng=None):
        """[B, T] ids -> [B, T, E] hidden states. ``rng`` (a host
        torch.Generator or a DropoutRng) feeds the dropout when
        ``deterministic`` is False."""
        B, T = texts.shape
        drop = dropout_stream(deterministic, rng, texts.device)
        pos = torch.arange(T, device=texts.device)[None, :].expand(B, T)
        x = self.encoder.embeddings(texts, pos, expand_langs(langs, T), drop)
        return self.encoder(x, pad_bias(pad_mask), drop)

    def project_hidden(self, h):
        """Tied vocab projection of hidden [..., E] -> fp32 logits [..., V]."""
        w = self.encoder.embeddings.word_embeddings.weight
        cd = self.cfg.compute_dtype
        logits = torch.nn.functional.linear(h.to(cd), w.to(cd))
        return logits.to(torch.float32) + self.out_bias

    def forward(self, texts, pad_mask, langs, deterministic: bool = True,
                rng=None):
        """Returns fp32 logits [B, T, V]."""
        return self.project_hidden(
            self.encode(texts, pad_mask, langs, deterministic, rng))
