"""Masked language model (port of imagetranslate_tpu/models/lm.py): the BERT
encoder with an output head tied to the word embeddings plus a free bias.

The full [B, T, V] logits come back and the train step masks the loss;
``encode`` / ``project_hidden`` are the split the step's masked-budget
projection uses. The encoder is the ``Encoder`` module of the translation
model under the same name, so the ``encoder.*`` keys of the two
``state_dict``s are the same: warm-starting a translation model from an LM
(``cli.train_mt --lm``) copies that sub-tree.

Under a mesh (``shard_``) the encoder holds this rank's shard of the JAX TP
rules and the word table its V/n rows; ``out_bias`` stays whole on every
rank (no JAX rule names it), and the tied ``project_hidden`` adds the
rank's slice of it to the rank's V/n logits columns (``vocab_range``).
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
from imagetranslate_tpu_torch.parallel.comm import tp_copy
from imagetranslate_tpu_torch.parallel.mesh import (
    Plan,
    ProcessMesh,
    module_plan,
    shard_module_,
)


class LM(nn.Module):
    """``param_dtype``: the dtype the Linear and Embedding weights are stored
    in (None: the compute dtype; ``torch.float32``: fp32 masters for
    training)."""

    mesh = None       # set by shard_
    vocab_tp = None   # the mesh when the word table's rows are split

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
        drop = dropout_stream(deterministic, rng, texts.device, self.mesh)
        pos = torch.arange(T, device=texts.device)[None, :].expand(B, T)
        x = self.encoder.embeddings(texts, pos, expand_langs(langs, T), drop)
        return self.encoder(x, pad_bias(pad_mask), drop)

    def shard_(self, mesh: ProcessMesh) -> Plan:
        """Keep this rank's shard of every parameter (the JAX TP rules), in
        place, and return the plan (as ``Seq2Seq.shard_``)."""
        plan = module_plan(self, mesh, self.cfg)
        shard_module_(self, mesh, plan)
        self.mesh = mesh
        if plan.get("encoder.embeddings.word_embeddings.weight") is not None:
            self.vocab_tp = mesh
        return plan

    def vocab_range(self):
        """[lo, hi) of the vocab columns ``project_hidden`` returns here."""
        if self.vocab_tp is None:
            return 0, self.cfg.vocab_size
        n = self.cfg.vocab_size // self.vocab_tp.n_model
        return self.vocab_tp.m * n, (self.vocab_tp.m + 1) * n

    def project_hidden(self, h):
        """Tied vocab projection of hidden [..., E] -> fp32 logits [..., V]
        (with the vocab split, the columns of ``vocab_range``)."""
        w = self.encoder.embeddings.word_embeddings.weight
        cd = self.cfg.compute_dtype
        b = self.out_bias
        tp = self.vocab_tp
        if tp is not None:
            # Replicated: its gradient is the group's sum of the slices'.
            h = tp_copy(h, tp.model_group)
            b = tp_copy(b, tp.model_group).chunk(tp.n_model)[tp.m]
        logits = torch.nn.functional.linear(h.to(cd), w.to(cd))
        return logits.to(torch.float32) + b

    def forward(self, texts, pad_mask, langs, deterministic: bool = True,
                rng=None):
        """Returns fp32 logits [B, T, V]."""
        return self.project_hidden(
            self.encode(texts, pad_mask, langs, deterministic, rng))
