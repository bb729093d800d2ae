"""Sentence-similarity model (port of imagetranslate_tpu/models/sensim.py:
``l2_normalize`` and ``SenSim``'s encode, similarity and InfoNCE forward).

The text encoder and a masked attention pool give one vector a sentence,
L2-normalised (the norm plus 1e-4); a pair's similarity is the dot product of
its two vectors. Training is a bidirectional InfoNCE over parallel pairs,
with in-batch negatives or with negative pools shared by both directions.

Under a data group (``shard_``, the train step's ``data_group``) each rank
encodes its rows and its share of each pool; the vectors are all-gathered
with their gradient (``all_gather_rows``), so that a rank's rows score
against the global columns, as ``s @ t_pool.T`` does over the JAX global
arrays.
"""

from __future__ import annotations

import torch
from torch import nn

from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.seq2seq import AttentionPool, expand_langs
from imagetranslate_tpu_torch.models.transformer import (
    Encoder,
    dropout_stream,
    pad_bias,
)
from imagetranslate_tpu_torch.parallel.comm import (
    all_gather_rows,
    all_gather_stack,
    group_rank,
)
from imagetranslate_tpu_torch.parallel.mesh import (
    Plan,
    ProcessMesh,
    module_plan,
    shard_module_,
)


def l2_normalize(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """x / (||x|| + eps) in fp32."""
    x = x.to(torch.float32)
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``all_gather_rows`` for vectors, and for a bool mask (gathered as
    int32, no gradient)."""
    if group is None:
        return x
    if x.dtype == torch.bool:
        return all_gather_stack(x.to(torch.int32), group).flatten(0, 1) > 0
    return all_gather_rows(x, group)


def infonce_mean(per_row: torch.Tensor, keep: torch.Tensor, count=None):
    """The mean of ``per_row`` over the rows ``keep`` holds; ``count``: the
    divisor in place of this rank's count (the global count under a mesh,
    where each rank's share adds up to the mean)."""
    keep = keep.to(torch.float32)
    if count is None:
        count = torch.sum(keep)
    return torch.sum(per_row * keep) / torch.clamp(count, min=1.0)


def shard_encoder_model_(model, mesh: ProcessMesh) -> Plan:
    """``shard_`` of the models built on one text ``Encoder`` (SenSim,
    Caption2Image): the JAX TP rules over it, the rest replicated."""
    plan = module_plan(model, mesh, model.cfg)
    shard_module_(model, mesh, plan)
    model.mesh = mesh
    return plan


def encode_pooled(model, src_ids, src_mask, src_langs, drop):
    """The text encoder and ``model.input_attention`` over it: [B, E] in the
    compute dtype (SenSim and Caption2Image share this front)."""
    B, T = src_ids.shape
    pos = torch.arange(T, device=src_ids.device)[None, :].expand(B, T)
    x = model.encoder.embeddings(src_ids, pos, expand_langs(src_langs, T),
                                 drop)
    states = model.encoder(x, pad_bias(src_mask), drop)
    return model.input_attention(states, src_mask)


class SenSim(nn.Module):
    """``param_dtype`` as in ``Seq2Seq`` (None: the compute dtype, for
    inference; ``torch.float32``: fp32 masters, for training). The encoder
    is ``models/transformer.Encoder`` under the translation model's name, so
    the ``encoder.*`` keys of the two ``state_dict``s are the same."""

    mesh = None   # set by shard_

    def __init__(self, cfg: Seq2SeqConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, device, param_dtype)
        self.input_attention = AttentionPool(cfg, device, param_dtype)

    shard_ = shard_encoder_model_

    def encode(self, src_ids, src_mask, src_langs,
               deterministic: bool = True, rng=None):
        """L2-normalised sentence vectors [B, E], fp32. ``rng`` (a host
        torch.Generator or a DropoutRng) feeds the dropout when
        ``deterministic`` is False."""
        drop = dropout_stream(deterministic, rng, src_ids.device, self.mesh)
        return l2_normalize(encode_pooled(self, src_ids, src_mask, src_langs,
                                          drop))

    def similarity(self, src_ids, src_mask, src_langs, tgt_ids, tgt_mask,
                   tgt_langs, deterministic: bool = True, rng=None):
        """Per-pair cosine [B]."""
        drop = dropout_stream(deterministic, rng, src_ids.device, self.mesh)
        s = self.encode(src_ids, src_mask, src_langs, deterministic, drop)
        t = self.encode(tgt_ids, tgt_mask, tgt_langs, deterministic, drop)
        return torch.sum(s * t, dim=-1)

    def forward(self, src_ids, src_mask, src_langs, tgt_ids, tgt_mask,
                tgt_langs, src_neg=None, src_neg_mask=None,
                src_neg_langs=None, tgt_neg=None, tgt_neg_mask=None,
                tgt_neg_langs=None, deterministic: bool = True, rng=None,
                row_mask=None, src_neg_row_mask=None, tgt_neg_row_mask=None,
                data_group=None, neg_groups=(None, None), count=None):
        """The InfoNCE loss, a scalar: the mean over the rows ``row_mask``
        keeps (all when None). With the pools ``src_neg``/``tgt_neg``, the
        columns are [tgt pool, tgt batch] for the source side and [src pool,
        src batch] for the target side, and each keeps its own padding
        columns out (``*_neg_row_mask``); without them, in-batch negatives.
        A dropped column takes -1e9, not -inf: exp is 0 either way, but a
        padded row's own (denom - nom) would be inf, whose 0-weighted
        product is NaN. ``data_group``: the group over which the pairs'
        rows are split (their vectors are gathered over it); ``neg_groups``:
        the same for the source and target pools; ``count``: the divisor of
        the mean (``infonce_mean``)."""
        drop = dropout_stream(deterministic, rng, src_ids.device, self.mesh)
        s = self.encode(src_ids, src_mask, src_langs, deterministic, drop)
        t = self.encode(tgt_ids, tgt_mask, tgt_langs, deterministic, drop)
        B = s.shape[0]
        rm = (torch.ones(B, dtype=torch.bool, device=s.device)
              if row_mask is None else row_mask)
        s_all, t_all, rm_all = (gather_rows(x, data_group)
                                for x in (s, t, rm))
        if src_neg is not None:
            sn = self.encode(src_neg, src_neg_mask, src_neg_langs,
                             deterministic, drop)
            tn = self.encode(tgt_neg, tgt_neg_mask, tgt_neg_langs,
                             deterministic, drop)

            def keep(mask, n):
                return (torch.ones(n, dtype=torch.bool, device=s.device)
                        if mask is None else mask)

            sn_keep = keep(src_neg_row_mask, sn.shape[0])
            tn_keep = keep(tgt_neg_row_mask, tn.shape[0])
            sn, sn_keep = (gather_rows(x, neg_groups[0])
                           for x in (sn, sn_keep))
            tn, tn_keep = (gather_rows(x, neg_groups[1])
                           for x in (tn, tn_keep))
            t_pool = torch.cat([tn, t_all], dim=0)
            s_pool = torch.cat([sn, s_all], dim=0)
            nom = torch.sum(s * t, dim=-1) + 1e-4
            cross = torch.cat([s @ t_pool.T, t @ s_pool.T], dim=1)
            col_keep = torch.cat([tn_keep, rm_all, sn_keep, rm_all])
            cross = torch.where(col_keep[None, :], cross, -1e9)
            denom = torch.log(torch.sum(torch.exp(cross), dim=-1) + 1e-4)
        else:
            cross = torch.where(rm_all[None, :], s @ t_all.T, -1e9)
            denom = torch.log(torch.sum(torch.exp(cross), dim=-1) + 1e-4)
            first = 0 if data_group is None else group_rank(data_group) * B
            rows = torch.arange(B, device=s.device)
            nom = cross[rows, first + rows] + 1e-4
        return infonce_mean(denom - nom, rm, count)
