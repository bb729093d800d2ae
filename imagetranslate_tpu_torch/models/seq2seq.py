"""The multilingual encoder-decoder (port of
imagetranslate_tpu/models/seq2seq.py: ProposalAttention, AttentionPool and
Seq2Seq's encode, forward, project, project_topk, init_cache and decode_step).

One language per batch: the decoder head is chosen by the language of the
FIRST target row, as in the JAX model (seq2seq.py:315). Here that index is a
host int, so the per-language decoders of ``lang_dec`` are plain indexing.

Under a mesh (``shard_``) the model holds this rank's shard of the JAX TP
rules; with the vocab split, ``project`` returns this rank's V/n logits
columns and ``project_topk`` takes K2b (``sharded_project_topk``).

``encode`` and ``decode_step`` are the spans ``model.encode`` and
``model.decode_step`` (``utils/profiling.py``).

The positions follow ``cfg.embedding`` (``token_positions``,
``step_position``): learned ones count from 0, sinusoidal ones (NLLB's) from
``pad_id`` + 1 over a row's real tokens, so a left-aligned row's positions
agree between ``encode``/``forward`` and the decode steps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.transformer import (
    Cache,
    Decoder,
    Encoder,
    OutputLayer,
    _linear,
    causal_pad_bias,
    dropout_stream,
    layer_norm,
    pad_bias,
    segment_bias,
    step_position,
    token_positions,
)
from imagetranslate_tpu_torch.ops import topk_project as tkp
from imagetranslate_tpu_torch.ops.attention import NEG_INF
from imagetranslate_tpu_torch.parallel.comm import tp_copy
from imagetranslate_tpu_torch.parallel.mesh import (
    Plan,
    ProcessMesh,
    module_plan,
    shard_module_,
)
from imagetranslate_tpu_torch.utils.profiling import spanned


def expand_langs(langs: torch.Tensor, seq_len: int) -> torch.Tensor:
    """[B] per-row language index -> [B, T] per-token."""
    if langs.ndim == 2:
        return langs
    return langs[:, None].expand(langs.shape[0], seq_len)


def first_lang(tgt_langs: torch.Tensor) -> int:
    """The batch's target language: that of its first row."""
    return int(tgt_langs.reshape(-1)[0].item())


class ProposalAttention(nn.Module):
    """Lexical-proposal gate: attend decoder states over candidate-word
    embeddings, blend through a learned sigmoid gate, LayerNorm."""

    def __init__(self, cfg: Seq2SeqConfig, device=None):
        super().__init__()
        self.gate = nn.Parameter(torch.full((1, cfg.hidden_size), 0.1,
                                            dtype=torch.float32,
                                            device=device))
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                      device=device, dtype=torch.float32)

    def forward(self, decoder_output, proposal_embed, proposal_pad_mask):
        """decoder_output [B, T, E]; proposal_embed [B, P, E];
        proposal_pad_mask [B, P], True at a real proposal token."""
        scores = torch.einsum("bte,bpe->btp", decoder_output.float(),
                              proposal_embed.float())
        scores = scores.masked_fill(~proposal_pad_mask[:, None, :], NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(proposal_embed.dtype)
        context = torch.einsum("btp,bpe->bte", probs, proposal_embed)
        # Rows with no proposal contribute ~nothing (the reference's 1e-8).
        empty = ~proposal_pad_mask.any(dim=-1)
        context = context.masked_fill(empty[:, None, None], 1e-8)
        sig = torch.sigmoid(self.gate + 1e-8).to(decoder_output.dtype)
        mixed = sig * decoder_output + (1.0 - sig) * context
        return layer_norm(self.LayerNorm, mixed)


class AttentionPool(nn.Module):
    """Masked attention pooling to one vector per sequence: the sentence or
    image embedding of the contrastive objective."""

    def __init__(self, cfg: Seq2SeqConfig, device=None, param_dtype=None):
        super().__init__()
        self.w = _linear(cfg, cfg.hidden_size, 1, device, param_dtype)

    def forward(self, states, keep_mask=None):
        """states [B, F, E]; keep_mask [B, F] or None. Returns [B, E]."""
        scores = self.w(states)[..., 0].to(torch.float32)
        if keep_mask is not None:
            scores = scores.masked_fill(~keep_mask, NEG_INF)
        probs = torch.softmax(scores, dim=1).to(states.dtype)
        return torch.einsum("bf,bfd->bd", probs, states)


class Seq2Seq(nn.Module):
    """``param_dtype`` is the dtype the Linear and Embedding weights are
    stored in: None (the default) stores the compute dtype, for serving;
    ``torch.float32`` holds fp32 masters, for training. Either way they are
    used in ``cfg.compute_dtype``."""

    mesh: Optional[ProcessMesh] = None       # set by shard_
    vocab_tp: Optional[ProcessMesh] = None   # the mesh when V is split

    def __init__(self, cfg: Seq2SeqConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        n_dec = cfg.num_languages if cfg.lang_dec else 1
        self.encoder = Encoder(cfg, device, param_dtype)
        if cfg.lang_dec:
            self.decoder = nn.ModuleList([Decoder(cfg, device, param_dtype)
                                          for _ in range(n_dec)])
            self.output_layer = nn.ModuleList([
                OutputLayer(cfg, device, param_dtype) for _ in range(n_dec)])
        else:
            self.decoder = Decoder(cfg, device, param_dtype)
            self.output_layer = OutputLayer(cfg, device, param_dtype)
        if cfg.use_proposals:
            self.proposal_attn = ProposalAttention(cfg, device)

    @staticmethod
    def _heads(mod):
        return list(mod) if isinstance(mod, nn.ModuleList) else [mod]

    @property
    def embeddings(self):
        return self.encoder.embeddings

    def _decoder(self, lang_idx: int) -> Decoder:
        return self._heads(self.decoder)[lang_idx if self.cfg.lang_dec else 0]

    def _head(self, lang_idx: int):
        """(weight [V, E] cast to the compute dtype, fp32 bias [V]) of the
        language's output projection; with the vocab split, this rank's V/n
        rows of both (the tied bias is replicated and sliced here)."""
        ol = self._heads(self.output_layer)[
            lang_idx if self.cfg.lang_dec else 0]
        w = (self.embeddings.word_embeddings.weight if self.cfg.tie_embed
             else ol.layer.weight)
        b = ol.layer.bias
        if self.vocab_tp is not None and b.shape[0] != w.shape[0]:
            # Replicated: its gradient is the group's sum of the slices'.
            # A copy, so that the kernel finds it 16-byte aligned.
            tp = self.vocab_tp
            b = tp_copy(b, tp.model_group).chunk(tp.n_model)[tp.m].clone()
        return w.to(self.cfg.compute_dtype), b

    def _drop(self, deterministic: bool, rng, device):
        return dropout_stream(deterministic, rng, device, self.mesh)

    def vocab_range(self) -> Tuple[int, int]:
        """[lo, hi) of the vocab columns ``project`` returns on this rank."""
        if self.vocab_tp is None:
            return 0, self.cfg.vocab_size
        n = self.cfg.vocab_size // self.vocab_tp.n_model
        return self.vocab_tp.m * n, (self.vocab_tp.m + 1) * n

    def shard_(self, mesh: ProcessMesh) -> Plan:
        """Keep this rank's shard of every parameter (JAX ``shard_params``
        under the TP rules; parallel/mesh.py), in place, and return the plan
        (state_dict key -> split dim or None). The parameters' values are
        kept: load a full state through ``shard_params`` with the plan
        afterwards. An MoE bank keeps its rank's experts (expert
        parallelism) and routes the data group's global batch
        (models/moe.py)."""
        plan = module_plan(self, mesh, self.cfg)
        shard_module_(self, mesh, plan)
        self.bind_mesh(mesh, plan)
        return plan

    def bind_mesh(self, mesh: ProcessMesh, plan: Plan, prefix: str = ""):
        """Record the mesh the model's shards belong to and whether the
        vocab is split (``plan``'s keys under ``prefix``: the model's name
        inside an enclosing module)."""
        self.mesh = mesh
        out = ("encoder.embeddings.word_embeddings.weight"
               if self.cfg.tie_embed else
               ("output_layer.0.layer.weight" if self.cfg.lang_dec
                else "output_layer.layer.weight"))
        self.vocab_tp = mesh if plan.get(prefix + out) is not None else None

    # ---------------- encoding ----------------

    @spanned("model.encode")
    def encode(self, src_ids, src_mask, src_langs, deterministic: bool = True,
               src_positions=None, src_segments=None, rng=None):
        """With ``src_segments`` (packed rows) attention stays inside each
        example's segment and ``src_positions`` restart per example.
        ``rng`` (a host torch.Generator) feeds the dropout when
        ``deterministic`` is False."""
        B, S = src_ids.shape
        drop = self._drop(deterministic, rng, src_ids.device)
        pos = token_positions(
            self.cfg, src_mask if src_segments is None else src_segments > 0,
            src_positions)
        x = self.embeddings(src_ids, pos, expand_langs(src_langs, S), drop)
        bias = (pad_bias(src_mask) if src_segments is None
                else segment_bias(src_segments, src_segments))
        return self.encoder(x, bias, drop)

    # ---------------- projections ----------------

    def project(self, hidden, lang_idx: int = 0):
        """hidden -> vocab logits (fp32 unless cfg.fp32_logits is off); with
        the vocab split, the columns of ``vocab_range``."""
        w, b = self._head(lang_idx)
        if self.vocab_tp is not None:
            hidden = tp_copy(hidden, self.vocab_tp.model_group)
        logits = torch.nn.functional.linear(hidden.to(w.dtype), w)
        if self.cfg.fp32_logits:
            return logits.to(torch.float32) + b
        return logits + b.to(logits.dtype)

    def project_topk(self, hidden, k: int, lang_idx: int = 0):
        """Vocab projection + exact top-k + logsumexp for the decode loop,
        through the projection kernel (ops/topk_project.py) for every head.
        fp32 weights and beams wider than the kernel's 16 take its plain
        version on the card too, as the JAX model takes XLA's top_k where
        the kernel's gate says no; any other call the kernel cannot take
        raises. Returns (val [M, k] fp32, idx [M, k] int32, lse [M] fp32).
        With the vocab split (JAX's gate: V divisible by the model axis),
        K2b: K2 over this rank's V/n rows, merged over the model group, the
        same triple on every rank of the group."""
        h = hidden[:, 0, :] if hidden.ndim == 3 else hidden
        w, b = self._head(lang_idx)
        if self.vocab_tp is not None:
            return tkp.sharded_project_topk(
                h.contiguous(), w, b, k, self.vocab_tp.model_group,
                plain=w.dtype == torch.float32 or k > tkp.MAX_K)
        if w.dtype == torch.float32 or k > tkp.MAX_K:
            return tkp.project_topk_reference(h, w, b, k)
        return tkp.project_topk(h.contiguous(), w, b, k)

    # ---------------- teacher-forced forward ----------------

    def forward(self, src_ids, src_mask, tgt_ids, tgt_mask, src_langs,
                tgt_langs, tgt_positions=None, proposals=None,
                proposal_mask=None, deterministic: bool = True,
                src_positions=None, src_segments=None, tgt_segments=None,
                rng=None):
        """Decoder consumes tgt[:, :-1]; returns logits [B, T-1, V] for
        tgt[:, 1:]. ``tgt_positions`` [B, T]: explicit decoder positions.
        ``src_segments``/``tgt_segments``: packed-row segment ids; self- and
        cross-attention stay inside each example's segment and the caller
        masks the cross-boundary loss slots. ``deterministic=False`` turns
        dropout on, its seeds drawn from ``rng`` (a host torch.Generator)."""
        B, T = tgt_ids.shape
        drop = self._drop(deterministic, rng, tgt_ids.device)
        enc_states = self.encode(src_ids, src_mask, src_langs, deterministic,
                                 src_positions=src_positions,
                                 src_segments=src_segments, rng=drop)
        # Only per-language decoders need the language on the host (a device
        # sync); the shared decoder's step stays asynchronous.
        lang_idx = first_lang(tgt_langs) if self.cfg.lang_dec else 0
        pos = token_positions(
            self.cfg, (tgt_mask if tgt_segments is None
                       else tgt_segments > 0)[:, :-1],
            None if tgt_positions is None else tgt_positions[:, :-1])
        x = self.embeddings(tgt_ids[:, :-1], pos,
                            expand_langs(tgt_langs, T)[:, :-1], drop)
        if tgt_segments is None:
            self_bias = causal_pad_bias(tgt_mask[:, :-1])
            cross_bias = pad_bias(src_mask)
        else:
            tseg = tgt_segments[:, :-1]
            self_bias = segment_bias(tseg, tseg, causal=True)
            cross_bias = segment_bias(tseg, src_segments)
        hidden = self._decoder(lang_idx)(x, enc_states, self_bias, cross_bias,
                                         drop)
        if self.cfg.use_proposals and proposals is not None:
            pe = self.embeddings.embed_words(proposals)
            hidden = self.proposal_attn(hidden, pe, proposal_mask)
        return self.project(hidden, lang_idx)

    # ---------------- decoding (KV cache) ----------------

    def init_cache(self, enc_states, batch: int, max_len: int,
                   lang_idx: int = 0) -> Cache:
        return self._decoder(lang_idx).init_cache(enc_states, batch, max_len)

    @spanned("model.decode_step")
    def decode_step(self, prev_token, cache: Cache, index: int, cross_bias,
                    tgt_langs, lang_idx: Optional[int] = None,
                    proposals=None, proposal_mask=None,
                    topk: Optional[int] = None):
        """prev_token [B, 1] ids written at position ``index``; the cache's
        self-attention buffers are updated in place. Returns fp32 logits
        [B, V], or with ``topk=k`` the project_topk triple."""
        B = prev_token.shape[0]
        if lang_idx is None:
            lang_idx = first_lang(tgt_langs)
        positions = torch.full((B, 1), step_position(self.cfg, index),
                               dtype=torch.long, device=prev_token.device)
        x = self.embeddings(prev_token, positions, expand_langs(tgt_langs, 1))
        hidden = self._decoder(lang_idx).step(x, cache, index, cross_bias)
        if self.cfg.use_proposals and proposals is not None:
            pe = self.embeddings.embed_words(proposals)
            hidden = self.proposal_attn(hidden, pe, proposal_mask)
        if topk is not None:
            return self.project_topk(hidden, topk, lang_idx)
        return self.project(hidden, lang_idx)[:, 0, :]
