"""Mixture-of-Experts feed-forward (port of imagetranslate_tpu/models/moe.py:
``_group_size``, ``_capacity`` and ``MoEFeedForward``).

A layer's dense FFN becomes a bank of ``cfg.moe_experts`` experts when
``cfg.moe_experts > 0`` (``models/transformer.py``). The routing is the JAX
module's, number for number:

- tokens are flattened batch-major ([B, S, H] in training, [B*K, 1, H] in a
  decode step) and routed in groups of ``_group_size`` tokens, each with its
  own per-expert capacity ``_capacity``;
- an fp32 router without a bias, a softmax, then a greedy top-k without
  replacement by ``argmax`` (ties go to the lowest expert index, as
  ``jnp.argmax`` gives them); the chosen gates are normalised (+1e-9) only
  for k > 1;
- the GShard queue: a token's slot at its expert is the running count of the
  group's earlier tokens sent there, and every second choice queues behind
  all first choices of the group; a token past the capacity is dropped from
  that expert (its contribution is zero; the residual carries it);
- the load-balance loss E * sum_e f_e * P_e over the first choices (f_e the
  share of tokens, P_e the mean router probability), reported only while a
  ``collect_aux`` block is open (the JAX module sows it into the "moe"
  collection, which only the train steps make mutable);
- the expert products in the compute dtype, exact gelu, dropout on the
  output, then the post-LN residual, as ``FeedForward``.

The JAX module dispatches through [G, S, E, C] one-hot einsums. Here a
token's row is copied to its (expert, group, slot) row of the expert input
and its outputs are gathered back from there: the same drop rule and the
same numbers, without the one-hot tensors. A dropped choice writes to a
trash row past the bank's slots, which no product reads. These are plain
batched products, outside any kernel, as in the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from imagetranslate_tpu_torch.models.config import Seq2SeqConfig


def _group_size(n_tokens: int, requested: int) -> int:
    """The largest divisor of the token count that is <= the requested group
    size; a prime count routes in groups of one, and ``requested == 0`` is
    one global group."""
    if not requested or n_tokens <= requested:
        return n_tokens
    for d in range(requested, 1, -1):
        if n_tokens % d == 0:
            return d
    return 1


def _capacity(n_tokens: int, cfg: Seq2SeqConfig) -> int:
    """Per-expert capacity of a group of ``n_tokens``:
    ceil(top_k * S * factor / E), at least 8, rounded up to a multiple of
    8."""
    c = int(-(-cfg.moe_top_k * n_tokens * cfg.moe_capacity_factor
              // cfg.moe_experts))
    return max(8, -(-c // 8) * 8)


class MoEFeedForward(nn.Module):
    """The routed expert bank that stands in a layer's dense FFN. Parameters
    as the flax module's: ``router`` (fp32 [E, H], no bias), ``wi``
    [E, H, F], ``bi`` [E, F], ``wo`` [E, F, H], ``bo`` [E, H] (stored in
    ``param_dtype``, used in the compute dtype) and the fp32 ``ln``."""

    def __init__(self, cfg: Seq2SeqConfig, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        E, H, FF = cfg.moe_experts, cfg.hidden_size, cfg.intermediate_size
        dt = cfg.compute_dtype if param_dtype is None else param_dtype
        kw = dict(device=device, dtype=dt)
        self.router = nn.Linear(H, E, bias=False, device=device,
                                dtype=torch.float32)
        self.wi = nn.Parameter(torch.zeros((E, H, FF), **kw))
        self.bi = nn.Parameter(torch.zeros((E, FF), **kw))
        self.wo = nn.Parameter(torch.zeros((E, FF, H), **kw))
        self.bo = nn.Parameter(torch.zeros((E, H), **kw))
        self.ln = nn.LayerNorm(H, eps=cfg.layer_norm_eps, device=device,
                               dtype=torch.float32)
        # Where the load-balance loss goes: a list while collect_aux is open.
        self.aux_sink: Optional[List[torch.Tensor]] = None

    def route(self, grp: torch.Tensor):
        """grp [G, S, H] -> (probs [G, S, E] fp32, per choice: expert index
        [G, S], gate [G, S] fp32, slot in the expert's queue [G, S])."""
        E, k = self.cfg.moe_experts, self.cfg.moe_top_k
        probs = torch.softmax(F.linear(grp.to(torch.float32),
                                       self.router.weight), dim=-1)
        remaining = probs
        idxs, gates, onehots = [], [], []
        for _ in range(k):
            idx = torch.argmax(remaining, dim=-1)           # the first max
            oh = F.one_hot(idx, E).to(torch.float32)
            idxs.append(idx)
            gates.append(torch.gather(probs, -1, idx[..., None])[..., 0])
            onehots.append(oh)
            remaining = remaining * (1.0 - oh)
        if k > 1:
            denom = sum(gates) + 1e-9
            gates = [g / denom for g in gates]
        slots = []
        offset = torch.zeros_like(probs[:, 0])              # [G, E]
        for oh in onehots:
            pos = torch.cumsum(oh, dim=1) - oh + offset[:, None, :]
            offset = offset + oh.sum(dim=1)
            slots.append((pos * oh).sum(dim=-1).to(torch.long))
        return probs, idxs, gates, slots, onehots[0]

    def forward(self, x: torch.Tensor, drop=None) -> torch.Tensor:
        cfg = self.cfg
        E, dtype = cfg.moe_experts, cfg.compute_dtype
        H = x.shape[-1]
        tokens = x.reshape(-1, H)
        T = tokens.shape[0]
        S = _group_size(T, cfg.moe_group_size)
        G = T // S
        C = _capacity(S, cfg)
        probs, idxs, gates, slots, first = self.route(tokens.reshape(G, S, H))
        if self.aux_sink is not None:
            f = first.mean(dim=(0, 1))
            p = probs.mean(dim=(0, 1))
            self.aux_sink.append(E * torch.sum(f * p))

        group = torch.arange(G, device=x.device)[:, None]
        trash = E * G * C
        rows = [torch.where(slot < C, (idx * G + group) * C + slot, trash)
                .reshape(-1) for idx, slot in zip(idxs, slots)]
        src = tokens.to(dtype)
        xin = src.new_zeros((trash + 1, H))
        for r in rows:
            xin = xin.index_copy(0, r, src)
        xin = xin[:trash].reshape(E, G * C, H)
        h = F.gelu(torch.bmm(xin, self.wi.to(dtype))
                   + self.bi.to(dtype)[:, None, :])
        y = torch.bmm(h, self.wo.to(dtype)) + self.bo.to(dtype)[:, None, :]
        y = torch.cat([y.reshape(trash, H), y.new_zeros((1, H))])
        # The combine in fp32 on compute-dtype gates and outputs (the JAX
        # einsum's operands, accumulated in fp32), rounded once.
        out = sum(g.reshape(-1, 1).to(dtype).to(torch.float32)
                  * y.index_select(0, r).to(torch.float32)
                  for g, r in zip(gates, rows))
        out = out.to(dtype).reshape(x.shape)
        if drop is not None:
            out = drop.dropout(out, cfg.dropout)
        return self.ln((out + x).to(torch.float32)).to(dtype)


@contextlib.contextmanager
def collect_aux(model: nn.Module):
    """Open a block in which every ``MoEFeedForward`` of ``model`` appends
    its load-balance loss to the list this yields, one entry a call."""
    sink: List[torch.Tensor] = []
    banks = [m for m in model.modules() if isinstance(m, MoEFeedForward)]
    for m in banks:
        m.aux_sink = sink
    try:
        yield sink
    finally:
        for m in banks:
            m.aux_sink = None
