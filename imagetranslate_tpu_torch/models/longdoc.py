"""Long-document masked LM at 4096 positions (port of
imagetranslate_tpu/models/longdoc.py): blockwise local attention, in which a
block of queries attends to its own block of keys and one block to each
side, O(T * 3 block) instead of O(T^2), as dense per-block products.

``local_block_attention`` is plain tensor code, as in the JAX package, where
it runs outside any kernel.

Sequence parallelism (``seq_sharding``, a ``ProcessMesh``; JAX
``seq_sharding``): rank (d, m) holds the rows of d and the m-th contiguous
run of whole blocks (``parallel.mesh.seq_range``), its positions offset by
its first token. Each layer's attention reads one block on each side of the
run: the ranks of the model group exchange their edge blocks of k, v and the
pad mask (``halo``), and the gradients of those blocks go back the same way;
the end ranks see zeros, masked out, as ``neighbors`` fills them. The
parameters stay whole on every rank (pure context parallelism).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.transformer import (
    DropoutRng,
    Embedding,
    _layer_norm,
    _linear,
    _param_dtype,
    dropout_stream,
    layer_norm,
)
from imagetranslate_tpu_torch.ops.attention import NEG_INF, attention_scale
from imagetranslate_tpu_torch.parallel.comm import all_gather_stack


class _Halo(torch.autograd.Function):
    """(left, right) [B, 1, block, ...]: the last block of the previous rank
    of the group and the first block of the next one (zeros at the ends),
    from this rank's blocks x [B, nb, block, ...]. Backward: the gradient
    of a block sent to a neighbour comes back from it."""

    @staticmethod
    def forward(ctx, x, group, m: int, n: int):
        ctx.group, ctx.m, ctx.n = group, m, n
        ctx.shape, ctx.dtype = x.shape, x.dtype
        parts = all_gather_stack(torch.stack([x[:, 0], x[:, -1]]), group)
        zeros = torch.zeros_like(x[:, :1])
        left = parts[m - 1][1][:, None] if m > 0 else zeros
        right = parts[m + 1][0][:, None] if m < n - 1 else zeros
        return left.contiguous(), right.contiguous()

    @staticmethod
    def backward(ctx, g_left, g_right):
        m, n = ctx.m, ctx.n
        parts = all_gather_stack(
            torch.stack([g_left[:, 0], g_right[:, 0]]).contiguous(),
            ctx.group)
        grad = g_left.new_zeros(ctx.shape)
        if m > 0:       # the first block went left, as that rank's right
            grad[:, 0] += parts[m - 1][1]
        if m < n - 1:   # the last block went right, as that rank's left
            grad[:, -1] += parts[m + 1][0]
        return grad, None, None, None


def halo(x: torch.Tensor, mesh):
    """The neighbouring blocks of a run of blocks ``x`` [B, nb, block, ...]
    under sequence parallelism over ``mesh``'s model group (``_Halo``); a
    bool mask crosses as int32 and carries no gradient."""
    if x.dtype == torch.bool:
        left, right = _Halo.apply(x.to(torch.int32), mesh.model_group,
                                  mesh.m, mesh.n_model)
        return left.bool(), right.bool()
    return _Halo.apply(x, mesh.model_group, mesh.m, mesh.n_model)


def longdoc_config(vocab_size: int, num_languages: int = 1,
                   size: int = 2) -> Seq2SeqConfig:
    """size: 1 = small, 2 = medium, 3 = base."""
    dims = {
        1: dict(hidden_size=64, intermediate_size=64, num_heads=1,
                enc_layers=4),
        2: dict(hidden_size=128, intermediate_size=256, num_heads=2,
                enc_layers=6),
        3: dict(hidden_size=256, intermediate_size=512, num_heads=2,
                enc_layers=6),
    }[size]
    return Seq2SeqConfig(vocab_size=vocab_size, num_languages=num_languages,
                         max_position_embeddings=4096, dec_layers=0, **dims)


def local_block_attention(q, k, v, pad_mask, block: int, mesh=None,
                          mask_halo=None):
    """q, k, v [B, T, H, D] with T % block == 0; pad_mask [B, T] bool. Each
    query block attends to its own and both neighbouring key blocks; a
    missing neighbour is zeros, masked out. fp32 scores and softmax, probs
    cast to v's dtype. Returns [B, T, H, D]. With ``mesh`` (sequence
    parallelism) the T positions are this rank's run, and the neighbours
    of its end blocks come from the model group (``halo``); ``mask_halo``:
    the pad mask's, when the caller has it already."""
    B, T, H, D = q.shape
    nb = T // block
    qb, kb, vb = (x.reshape(B, nb, block, H, D) for x in (q, k, v))
    maskb = pad_mask.reshape(B, nb, block)

    def neighbors(x, edges=None):
        if edges is None:
            zeros = torch.zeros_like(x[:, :1])
            edges = zeros, zeros
        prev = torch.cat([edges[0], x[:, :-1]], dim=1)
        nxt = torch.cat([x[:, 1:], edges[1]], dim=1)
        return torch.cat([prev, x, nxt], dim=2)

    split = mesh is not None and mesh.model_group is not None
    k_ctx = neighbors(kb, halo(kb, mesh) if split else None)
    v_ctx = neighbors(vb, halo(vb, mesh) if split else None)
    if split and mask_halo is None:
        mask_halo = halo(maskb, mesh)
    m_ctx = neighbors(maskb, mask_halo if split else None)  # [B, nb, 3 blk]

    scores = torch.einsum("bnqhd,bnkhd->bnhqk", qb.to(torch.float32),
                          k_ctx.to(torch.float32)) * attention_scale(D)
    bias = torch.where(m_ctx[:, :, None, None, :], 0.0, NEG_INF)
    probs = torch.softmax(scores + bias, dim=-1).to(v_ctx.dtype)
    ctx = torch.einsum("bnhqk,bnkhd->bnqhd", probs, v_ctx)
    return ctx.reshape(B, T, H, D)


class LocalAttentionLayer(nn.Module):
    """Local block attention and the dense-gelu-dense FFN, each with a
    post-LN residual."""

    def __init__(self, cfg: Seq2SeqConfig, block: int = 128, device=None,
                 param_dtype=None):
        super().__init__()
        self.cfg, self.block = cfg, block
        E, FF = cfg.hidden_size, cfg.intermediate_size
        for name in ("query", "key", "value", "out"):
            setattr(self, name, _linear(cfg, E, E, device, param_dtype))
        self.ln1 = _layer_norm(cfg, device)
        self.intermediate = _linear(cfg, E, FF, device, param_dtype)
        self.output = _linear(cfg, FF, E, device, param_dtype)
        self.ln2 = _layer_norm(cfg, device)

    def forward(self, x, pad_mask, drop: Optional[DropoutRng] = None,
                mesh=None, mask_halo=None):
        cfg = self.cfg

        def heads(t):
            return t.reshape(*t.shape[:-1], cfg.num_heads, cfg.head_dim)

        ctx = local_block_attention(heads(self.query(x)), heads(self.key(x)),
                                    heads(self.value(x)), pad_mask,
                                    self.block, mesh, mask_halo)
        out = self.out(ctx.reshape(*ctx.shape[:2], -1))
        if drop is not None:
            out = drop.dropout(out, cfg.dropout)
        x = layer_norm(self.ln1, out + x)
        out = self.output(F.gelu(self.intermediate(x)))   # exact (erf) gelu
        if drop is not None:
            out = drop.dropout(out, cfg.dropout)
        return layer_norm(self.ln2, out + x)


class LongDocLM(nn.Module):
    """4096-position MLM with local block attention; the same surface as
    ``models.lm.LM`` (``encode``, ``project_hidden``, ``forward``), so the
    MLM steps take either. ``seq_sharding``: a ``ProcessMesh`` whose model
    axis splits the sequence (None: every position here)."""

    def __init__(self, cfg: Seq2SeqConfig, block: int = 128,
                 seq_sharding=None, device=None, param_dtype=None):
        super().__init__()
        if cfg.moe_experts:
            # The JAX LongDocLM's layers keep their dense FFN whatever the
            # config says, and its MLM step then averages no aux losses.
            raise ValueError("the long-document LM has a dense FFN in every "
                             "layer (as in the JAX package): moe_experts "
                             "must be 0")
        self.cfg, self.block = cfg, block
        self.mesh = seq_sharding
        E = cfg.hidden_size
        kw = dict(device=device, dtype=_param_dtype(cfg, param_dtype))
        cd = cfg.compute_dtype
        self.word = Embedding(cfg.vocab_size, E, cd, **kw)
        self.position = Embedding(cfg.max_position_embeddings, E, cd, **kw)
        self.lang = Embedding(max(1, cfg.num_languages), E, cd, **kw)
        self.ln = _layer_norm(cfg, device)
        self.layers = nn.ModuleList([
            LocalAttentionLayer(cfg, block, device, param_dtype)
            for _ in range(cfg.enc_layers)])
        self.out_bias = nn.Parameter(torch.zeros(
            cfg.vocab_size, dtype=torch.float32, device=device))

    def encode(self, texts, pad_mask, langs, deterministic: bool = True,
               rng=None):
        """[B, T] ids -> [B, T, E] hidden states. Under ``seq_sharding``
        the rank's rows and run of positions (``langs`` [B] or the rank's
        [B, T])."""
        B, T = texts.shape
        if T % self.block != 0:
            raise ValueError("long-doc sequences must be multiples of "
                             f"block={self.block}, got T={T}")
        mesh = self.mesh
        split = self.seq_parallel
        drop = dropout_stream(deterministic, rng, texts.device, mesh,
                              seq=split)
        if langs.ndim == 1:
            langs = langs[:, None].expand(B, T)
        first = mesh.m * T if split else 0
        pos = torch.arange(first, first + T,
                           device=texts.device)[None, :].expand(B, T)
        x = self.word(texts) + self.position(pos) + self.lang(langs)
        x = layer_norm(self.ln, x)
        if drop is not None:
            x = drop.dropout(x, self.cfg.dropout)
        # The pad mask's halo is the same in every layer.
        mask_halo = (halo(pad_mask.reshape(B, T // self.block, self.block),
                          mesh) if split else None)
        for layer in self.layers:
            x = layer(x, pad_mask, drop, mesh if split else None, mask_halo)
        return x

    @property
    def seq_parallel(self) -> bool:
        """Does the model group split the sequence?"""
        return self.mesh is not None and self.mesh.model_group is not None

    def project_hidden(self, h):
        """Tied vocab projection of hidden [..., E] -> fp32 logits [..., V]."""
        cd = self.cfg.compute_dtype
        logits = F.linear(h.to(cd), self.word.weight.to(cd))
        return logits.to(torch.float32) + self.out_bias

    def forward(self, texts, pad_mask, langs, deterministic: bool = True,
                rng=None):
        return self.project_hidden(
            self.encode(texts, pad_mask, langs, deterministic, rng))
