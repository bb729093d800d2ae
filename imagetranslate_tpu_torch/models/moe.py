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
  collection, which only the train steps make mutable), and not again when
  a checkpointed block recomputes in the backward (``models/remat.py``);
- the expert products in the compute dtype, exact gelu (relu with
  ``cfg.activation``), dropout on the output, then the post-LN residual, as
  ``FeedForward``.

The JAX module dispatches through [G, S, E, C] one-hot einsums. Here a
token's row is copied to its (expert, group, slot) row of the expert input
and its outputs are gathered back from there: the same drop rule and the
same numbers, without the one-hot tensors. A dropped choice writes to a
trash row past the bank's slots, which no product reads. These are plain
batched products, outside any kernel, as in the JAX package.

Expert parallelism (``Seq2Seq.shard_`` under a model axis that divides the
experts; the JAX rules split the banks' expert dim): rank m holds experts
[m E/n, (m + 1) E/n). The tokens reach every rank of the model group whole,
so every rank routes them alike, with the same capacity drops; a rank
dispatches only the choices of its own experts (the others go to the trash
row) and combines its partial sum, which the model group sums
(``tp_reduce``), before the dropout and the residual. No all-to-all is
needed. The gradients: the dispatched tokens and the combine's gates see
only this rank's experts, so theirs are summed over the group
(``tp_copy``); the load-balance loss reads the router's probabilities
whole on every rank and its gradient is not summed. The router's gradient is
thus the one-process gradient on every rank.

Inference without drops (``cfg.moe_inference == "dropless"``, NLLB-MoE's
routing at inference; ``_dropless``): every call outside autograd routes
each token to its top-k experts with no capacity, all on the device and
with no host sync: an fp32 router without a bias and a softmax, a greedy
top-k by ``argmax``, the gates p_e / sum of the chosen p; the k T choices
sorted by expert (``torch.argsort``, stable), counted into device offsets
(a scatter and ``cumsum``), the rows gathered, one grouped product over the
experts' segments for ``wi`` (``expert_product``: ``torch._grouped_mm`` for
bf16 on the card, a loop over the segments elsewhere), bias and the
activation, one for ``wo`` and its bias, each output scaled by its gate and
``cfg.moe_inference_scale``, and ``index_add`` back into the tokens' rows in
fp32, rounded once. Padding tokens are routed like any other token. Under
autograd it raises: its training (a capacity, token dropout, the router's
losses) is not built. Its spans are ``moe.route``, ``moe.dispatch`` (sort,
offsets, gather), ``moe.experts`` (both products) and ``moe.combine``; its
counters ``moe.choices`` (k T a call) and, while tracing, ``moe.max_load``
(the largest segment a call, kept on the device and read once after the
decode loop, ``profiling.count_later``).

With ``cfg.pre_layer_norm`` the bank's ``ln`` normalises its input and the
output (after dropout) is added to the residual, on either path.

Data parallelism (a mesh with a data group): JAX routes the global batch, so
a group of tokens may span two data ranks, and the load-balance loss is
taken over every token. Each data rank holds a run of the global token order
(its rows), so each gathers the expert choices of every rank (indices only,
one all-gather a choice), finds the groups, slots and drops of the global
order, and dispatches its own tokens into the groups its run touches; the
experts are row-wise, so a token's output does not depend on where it is
computed. The loss's token shares come from the gathered choices, its mean
probabilities from a sum over the data group whose gradient goes to each
rank's own tokens. The ranks of a data group must call the bank together,
each with its own rows: the train steps and the row-split decodes do.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.remat import recomputing
from imagetranslate_tpu_torch.parallel.comm import (
    all_gather_stack,
    group_size,
    tp_copy,
    tp_reduce,
)
from imagetranslate_tpu_torch.utils import profiling
from imagetranslate_tpu_torch.utils.profiling import span


def activation(cfg: Seq2SeqConfig):
    """The FFN's and the experts' nonlinearity: exact gelu or relu."""
    return F.relu if cfg.activation == "relu" else F.gelu


def expert_product(x: torch.Tensor, w: torch.Tensor,
                   offs: torch.Tensor) -> torch.Tensor:
    """x [N, K] rows sorted by expert, w [E, K, M], offs [E] int32 (the end
    of each expert's run of rows) -> [N, M], row r times its expert's w:
    one ``torch._grouped_mm`` for bf16 on the card (offsets read there, no
    host sync); elsewhere a loop over the experts' segments, their ends read
    on the host."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return torch._grouped_mm(x, w, offs=offs)
    out = x.new_zeros((x.shape[0], w.shape[-1]))
    start = 0
    for e, end in enumerate(offs.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[e]
        start = end
    return out


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

    tp = None   # the mesh when the experts are split
    dp = None   # the mesh when it has a data group

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

    def _group(self):
        return None if self.tp is None else self.tp.model_group

    def route(self, grp: torch.Tensor):
        """grp [G, S, H] (one rank's tokens in their groups) -> (probs
        [G, S, E] fp32, per choice: expert index [G, S], gate [G, S] fp32,
        slot in the expert's queue [G, S], and the first choices [G, S, E]
        one-hot)."""
        G, S, H = grp.shape
        probs, idxs, gates, slots, first = self._route(
            grp.reshape(-1, H), 0, S, None)
        return (probs.reshape(G, S, -1), [i.reshape(G, S) for i in idxs],
                [g.reshape(G, S) for g in gates],
                [s.reshape(G, S) for s in slots], first.reshape(G, S, -1))

    def _route(self, tokens: torch.Tensor, start: int, S: int, data):
        """tokens [T, H], this rank's run of the global token order from
        ``start``, in groups of ``S`` (``data``: the data group whose ranks
        hold the other runs, or None) -> (probs [T, E] fp32, per choice:
        expert index [T], gate [T] fp32, slot in its expert's queue of the
        token's group [T], and the global first choices [T_global, E]
        one-hot)."""
        E, k = self.cfg.moe_experts, self.cfg.moe_top_k
        T = tokens.shape[0]
        probs = torch.softmax(F.linear(tokens.to(torch.float32),
                                       self.router.weight), dim=-1)
        gate_probs = tp_copy(probs, self._group())
        remaining = probs
        idxs, gates, onehots = [], [], []
        for _ in range(k):
            idx = torch.argmax(remaining, dim=-1)           # the first max
            oh = F.one_hot(idx, E).to(torch.float32)
            idxs.append(idx)
            gates.append(torch.gather(gate_probs, -1, idx[..., None])[..., 0])
            onehots.append(all_gather_stack(oh, data).reshape(-1, S, E))
            remaining = remaining * (1.0 - oh)
        if k > 1:
            denom = sum(gates) + 1e-9
            gates = [g / denom for g in gates]
        # The GShard queue over the global order: a token's slot at its
        # expert counts the group's earlier choices of it, every second
        # choice behind all first choices.
        slots = []
        offset = torch.zeros_like(onehots[0][:, 0])         # [G, E]
        for oh in onehots:
            pos = torch.cumsum(oh, dim=1) - oh + offset[:, None, :]
            offset = offset + oh.sum(dim=1)
            slot = (pos * oh).sum(dim=-1).to(torch.long).reshape(-1)
            slots.append(slot[start:start + T])
        return probs, idxs, gates, slots, onehots[0].reshape(-1, E)

    def forward(self, x: torch.Tensor, drop=None) -> torch.Tensor:
        cfg = self.cfg
        dtype = cfg.compute_dtype
        h = (self.ln(x.to(torch.float32)).to(dtype) if cfg.pre_layer_norm
             else x)
        if cfg.moe_inference == "dropless":
            if torch.is_grad_enabled():
                raise NotImplementedError(
                    "moe_inference='dropless' (an NLLB-MoE-style config: "
                    f"{cfg.moe_experts} experts, top-{cfg.moe_top_k}, an MoE "
                    f"layer every {cfg.moe_every}) routes without drops at "
                    "inference only; its training (an expert capacity, "
                    "token dropout, the router's z-loss and aux loss) is "
                    "not built, and the capacity path does not stand in "
                    "for it")
            if self.tp is not None or self.dp is not None:
                raise NotImplementedError(
                    "moe_inference='dropless' runs the whole bank on one "
                    "device: no expert or data parallelism")
            out = self._dropless(h)
        else:
            out = self._capacity(h)
        if drop is not None:
            out = drop.dropout(out, cfg.dropout)
        if cfg.pre_layer_norm:
            return x + out
        return self.ln((out + x).to(torch.float32)).to(dtype)

    def _dropless(self, x: torch.Tensor) -> torch.Tensor:
        """The bank without a capacity (module docstring): x [..., H] in
        the compute dtype -> the experts' gated sum [..., H]."""
        cfg = self.cfg
        E, k, dtype = cfg.moe_experts, cfg.moe_top_k, cfg.compute_dtype
        H = x.shape[-1]
        tokens = x.reshape(-1, H)
        T = tokens.shape[0]
        with span("moe.route"):
            idxs, gates = self.route_dropless(tokens)
        with span("moe.dispatch"):
            expert = torch.cat(idxs)                 # choice j T + t
            order = torch.argsort(expert, stable=True)
            # A scatter, not bincount: bincount on the card reads its
            # input's largest value on the host.
            counts = torch.zeros(E, dtype=torch.long,
                                 device=x.device).scatter_add_(
                0, expert, torch.ones_like(expert))
            offs = torch.cumsum(counts, 0).to(torch.int32)
            token = order % T
            e_sorted = expert.index_select(0, order)
            xs = tokens.to(dtype).index_select(0, token)
        with span("moe.experts"):
            h = expert_product(xs, self.wi.to(dtype), offs)
            h = activation(cfg)(h + self.bi.to(dtype).index_select(
                0, e_sorted))
            y = expert_product(h, self.wo.to(dtype), offs)
            y = y + self.bo.to(dtype).index_select(0, e_sorted)
        with span("moe.combine"):
            scale = torch.cat(gates).index_select(
                0, order) * cfg.moe_inference_scale
            out = torch.zeros((T, H), dtype=torch.float32, device=x.device)
            out.index_add_(0, token, y.to(torch.float32) * scale[:, None])
        profiling.count("moe.choices", k * T)
        if profiling.tracing:
            profiling.count_later("moe.max_load", counts.max())
        return out.to(dtype).reshape(x.shape)

    def route_dropless(self, tokens: torch.Tensor):
        """tokens [T, H] -> (per choice j: expert index [T], gate [T] fp32):
        the fp32 router's softmax, a greedy top-k by ``argmax`` (ties to the
        lowest index), the gates p_e over the sum of the chosen p."""
        probs = torch.softmax(F.linear(tokens.to(torch.float32),
                                       self.router.weight), dim=-1)
        remaining, idxs, gates = probs, [], []
        for _ in range(self.cfg.moe_top_k):
            idx = torch.argmax(remaining, dim=-1)          # the first max
            idxs.append(idx)
            gates.append(torch.gather(probs, -1, idx[:, None])[:, 0])
            remaining = remaining.scatter(-1, idx[:, None], -1.0)
        denom = sum(gates)
        return idxs, [g / denom for g in gates]

    def _capacity(self, x: torch.Tensor) -> torch.Tensor:
        """The GShard bank (module docstring): x [..., H] -> the experts'
        gated sum [..., H], before the dropout and the residual."""
        cfg = self.cfg
        E, dtype = cfg.moe_experts, cfg.compute_dtype
        H = x.shape[-1]
        tokens = x.reshape(-1, H)
        T = tokens.shape[0]
        data = None if self.dp is None else self.dp.data_group
        T_all = T * group_size(data)
        start = 0 if data is None else self.dp.d * T
        S = _group_size(T_all, cfg.moe_group_size)
        C = _capacity(S, cfg)
        probs, idxs, gates, slots, first = self._route(tokens, start, S,
                                                       data)
        if self.aux_sink is not None or torch.is_grad_enabled():
            # Under autograd always computed, so that a recompute saves what
            # the forward saved; reported once, by the forward. Over the
            # global batch: the mean probability is the data group's sum.
            f = first.mean(dim=0)
            p = tp_reduce(probs.sum(dim=0), data) / T_all
            aux = E * torch.sum(f * p)
            if self.aux_sink is not None and not recomputing():
                self.aux_sink.append(aux)

        # This rank's experts [lo, lo + n): all of them unless split; the
        # groups [g0, g0 + G) its tokens touch.
        n = self.wi.shape[0]
        lo = 0 if self.tp is None else self.tp.m * n
        g0 = start // S
        G = (start + T - 1) // S - g0 + 1
        group = torch.arange(start, start + T, device=x.device) // S - g0
        trash = n * G * C
        rows = [torch.where((slot < C) & (idx >= lo) & (idx < lo + n),
                            ((idx - lo) * G + group) * C + slot, trash)
                for idx, slot in zip(idxs, slots)]
        src = tp_copy(tokens, self._group()).to(dtype)
        xin = src.new_zeros((trash + 1, H))
        for r in rows:
            xin = xin.index_copy(0, r, src)
        xin = xin[:trash].reshape(n, G * C, H)
        h = activation(cfg)(torch.bmm(xin, self.wi.to(dtype))
                            + self.bi.to(dtype)[:, None, :])
        y = torch.bmm(h, self.wo.to(dtype)) + self.bo.to(dtype)[:, None, :]
        y = torch.cat([y.reshape(trash, H), y.new_zeros((1, H))])
        # The combine in fp32 on compute-dtype gates and outputs (the JAX
        # einsum's operands, accumulated in fp32), rounded once.
        out = sum(g.reshape(-1, 1).to(dtype).to(torch.float32)
                  * y.index_select(0, r).to(torch.float32)
                  for g, r in zip(gates, rows))
        return tp_reduce(out, self._group()).to(dtype).reshape(x.shape)


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
