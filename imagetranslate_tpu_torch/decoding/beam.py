"""KV-cached batched beam search (port of imagetranslate_tpu/decoding/beam.py:
``beam_search`` and ``beam_search_dual`` with the gather cache, greedy K=1,
``max_len_for`` and ``trim_outputs``).

Each step decodes ONE token per beam against a [B*K, L, H, D] self-attention
cache and reorders the cache rows by an index gather after the beam
selection. (The JAX default is a windowed-consolidation cache that permutes
index maps instead of the cache; its outputs equal the gather path's,
tests/test_beam.py, and the port starts from the gather semantics.) The
encoder states, their cross-attention K/V [B, S, H, D] and the cross bias
[B, 1, 1, S] stay once a source, as in the JAX decoders: the K beams of a
source read the one copy (``ops/cross_attention.py``).

Reference semantics kept exactly as the JAX decoder has them:
- the GNMT length penalty ((len + 6)/6)^alpha through the compounding
  recurrence score_i = (score_{i-1} + logp_i) / penalty(size_{i-1});
- per-row limits floor(a*src_size + b), capped at L, in fp32 as JAX does;
- two-stage selection: per-beam top-K over the vocab (Seq2Seq.project_topk,
  the projection kernel on the card), then top-K over the K*K candidates,
  both breaking ties on the lowest index (``stable_topk``);
- ``ref_ties`` reproduces the reference decoder's tie/limit quirks (a frozen
  beam ties across the vocab; rows past their limit collapse onto beam 0;
  slot j is padded whenever parent beam j was finished); ``ref_ties=False``
  gives the clean semantics;
- early exit once every beam of every row is finished; greedy (K=1) skips the
  penalty and the cache reorder.

Spans and counters (``utils/profiling.py``): ``decode.search`` a call,
``decode.step`` a loop iteration, ``decode.select`` the selection and the
cache reorder, ``decode.exit_check`` the early exit's host sync;
``decode.rows`` and ``decode.rows_live`` (``_beam_loop``), which also
settles the device counters its steps kept (``moe.max_load``).

Under a tensor-parallel model (``Seq2Seq.shard_``) every rank of the model
group gets the same merged triple from K2b, so the beams' bookkeeping, and
the early exit that reads it, stay in lockstep with no further collective.
Ranks that decode rows of their own (``data_group``) exit together, when
every beam of every rank is finished: a rank's rows then take the steps
they would take in one decode of all the rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from imagetranslate_tpu_torch.models.seq2seq import first_lang
from imagetranslate_tpu_torch.models.transformer import pad_bias
from imagetranslate_tpu_torch.ops.topk_project import stable_topk
from imagetranslate_tpu_torch.parallel.comm import all_reduce_max
from imagetranslate_tpu_torch.utils import profiling
from imagetranslate_tpu_torch.utils.profiling import span, spanned

NEG = -1e9


def reorder_caches(caches, rows: torch.Tensor):
    """Reorder every layer's cache rows by ``rows`` [B*K] in place of the
    dicts' tensors: an index gather, exact in every dtype. (The JAX
    ``_gather_beams`` permutes through a bf16 one-hot product, which rounds
    an fp32 cache to bf16 at every step; the port keeps the cache exact.)"""
    for cache in caches:
        for layer in cache:
            layer["k"] = layer["k"].index_select(0, rows)
            layer["v"] = layer["v"].index_select(0, rows)


def max_len_for(src_len: int, max_len_a: float, max_len_b: int,
                max_positions: int) -> int:
    """Decode buffer length for a source length (static sizing)."""
    return min(int(max_len_a * src_len + max_len_b), max_positions)


def _max_lens(src_sizes, B: int, L: int, max_len_a: float, max_len_b: int,
              dev) -> torch.Tensor:
    """Per-row decode limits floor(a * src_size + b), capped at L, in fp32 as
    the JAX decoder computes them; L for every row without ``src_sizes``."""
    if src_sizes is None:
        return torch.full((B,), L, dtype=torch.int32, device=dev)
    per_row = torch.floor(max_len_a * src_sizes.to(torch.float32)
                          + max_len_b).to(torch.int32)
    return torch.clamp(per_row, max=L)


def _all_finished(finished: torch.Tensor, data_group) -> bool:
    """The early exit's test: the loop's one host sync a step (span
    ``decode.exit_check``)."""
    with span("decode.exit_check"):
        if data_group is None:
            return bool(finished.all())
        busy = (~finished).any().to(torch.int32).reshape(1)
        return not bool(all_reduce_max(busy, data_group))


def _beam_loop(step, caches, first_tokens, max_lens, *, beam_width: int,
               max_len: int, len_penalty_ratio: float, pad_id: int,
               eos_id: int, ref_ties: bool, data_group=None):
    """The decode loop and its selection, shared by ``beam_search`` and
    ``beam_search_dual``. ``step(prev [B*K, 1], index)`` decodes one token
    per beam and returns the project_topk triple; ``caches`` are the
    self-attention caches (lists of layer dicts) whose rows follow the
    selected beams, all reordered together.

    Spans: ``decode.step`` an iteration, ``decode.select`` from the
    candidates to the cache reorder. Counters: ``decode.rows`` (B * K a
    step) and, while tracing, ``decode.rows_live`` (the rows neither
    finished nor past their limit), whose per-step masks are summed on the
    device and read once after the loop."""
    B = first_tokens.shape[0]
    K, L = beam_width, max_len
    dev = first_tokens.device

    tokens = torch.full((B, K, L), pad_id, dtype=torch.long, device=dev)
    tokens[:, :, 0] = first_tokens[:, None]
    # Only beam 0 is live at step 1; the others start at NEG so the first
    # selection fans out from beam 0 alone.
    scores = torch.zeros((B, K), dtype=torch.float32, device=dev)
    scores[:, 1:] = NEG
    sizes = torch.zeros((B, K), dtype=torch.float32, device=dev)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    slot0 = torch.arange(K, device=dev)[None, None, :] == 0
    row_base = torch.arange(B, device=dev)[:, None] * K
    frozen_masks = [] if profiling.tracing else None

    i = 1
    while i < L and not _all_finished(finished, data_group):
        with span("decode.step"):
            prev = tokens[:, :, i - 1].reshape(B * K, 1)
            top_val, top_word, lse = step(prev, i - 1)
            with span("decode.select"):
                top_logp = (top_val - lse[:, None]).reshape(B, K, K)
                top_word = top_word.reshape(B, K, K).to(torch.long)

                row_done = (max_lens < i + 1)[:, None]           # [B, 1]
                frozen = finished | row_done                      # [B, K]
                fz = frozen[:, :, None]
                if ref_ties and K > 1:
                    cand_logp = torch.where(fz, 0.0, top_logp)
                else:
                    cand_logp = torch.where(
                        fz, torch.where(slot0, 0.0, NEG), top_logp)
                cand_word = torch.where(fz, pad_id, top_word)
                cand = scores[:, :, None] + cand_logp
                if K > 1:
                    penalty = torch.pow((sizes + 6.0) / 6.0,
                                        len_penalty_ratio)
                    cand = cand / penalty[:, :, None]

                top_scores, top_idx = stable_topk(cand.reshape(B, K * K), K)
                beam_idx = top_idx // K
                word = torch.gather(cand_word.reshape(B, K * K), 1, top_idx)
                if ref_ties and K > 1:
                    beam_idx = torch.where(row_done, 0, beam_idx)
                    word = torch.where(row_done, pad_id, word)
                    word = torch.where(finished, pad_id, word)

                tokens = torch.gather(
                    tokens, 1, beam_idx[:, :, None].expand(B, K, L))
                tokens[:, :, i] = word
                sizes = (torch.gather(sizes, 1, beam_idx)
                         + (word != pad_id).float())
                finished = torch.gather(frozen, 1, beam_idx) | (
                    word == eos_id)
                scores = top_scores
                if K > 1:
                    reorder_caches(caches, (row_base + beam_idx).reshape(-1))
            profiling.count("decode.rows", B * K)
            if frozen_masks is not None:
                frozen_masks.append(frozen)
        i += 1
    if frozen_masks:
        profiling.count("decode.rows_live",
                        int((~torch.stack(frozen_masks)).sum()))
    if profiling.tracing:
        profiling.settle()      # the MoE banks' loads (models/moe.py)

    best = tokens[:, 0, :]
    is_eos = best == eos_id
    first_eos = torch.argmax(is_eos.to(torch.int32), dim=1)  # first max
    lengths = torch.where(is_eos.any(dim=1), first_eos,
                          max_lens.to(torch.long))
    return best, lengths


@torch.no_grad()
@spanned("decode.search")
def beam_search(
    model,                        # Seq2Seq or ImageSeq2Seq
    enc_states: torch.Tensor,     # [B, S, E] text states or an image grid
    src_mask: torch.Tensor,       # [B, S] keep-mask for cross-attention
    first_tokens: torch.Tensor,   # [B] initial (target-language) token
    tgt_langs: torch.Tensor,      # [B] target language index
    src_sizes: Optional[torch.Tensor] = None,       # [B] true source lengths
    proposals: Optional[torch.Tensor] = None,       # [B, P] --dict candidates
    proposal_mask: Optional[torch.Tensor] = None,   # [B, P]
    *,
    beam_width: int = 4,
    max_len: int = 128,
    max_len_a: float = 1.3,
    max_len_b: int = 5,
    len_penalty_ratio: float = 0.8,
    pad_id: int = 0,
    eos_id: int = 4,
    ref_ties: bool = True,
    data_group=None,
):
    """Returns (best [B, L] int64: the top beam per row, starting with the
    first token, padded after EOS; lengths [B] int64: index of the first EOS,
    or the row's limit). ``data_group``: the ranks that decode other rows
    of the same batch (with the same L), whose early exit this one joins."""
    B = enc_states.shape[0]
    K, L = beam_width, max_len
    lang_idx = first_lang(tgt_langs)
    max_lens = _max_lens(src_sizes, B, L, max_len_a, max_len_b,
                         enc_states.device)

    def rep(x):
        return None if x is None else x.repeat_interleave(K, dim=0)

    cross_bias = pad_bias(src_mask)
    langs_k, prop_k, pmask_k = rep(tgt_langs), rep(proposals), rep(
        proposal_mask)
    cache = model.init_cache(enc_states, B * K, L, lang_idx)

    def step(prev, index):
        return model.decode_step(prev, cache, index, cross_bias, langs_k,
                                 lang_idx, proposals=prop_k,
                                 proposal_mask=pmask_k, topk=K)

    return _beam_loop(step, [cache], first_tokens, max_lens, beam_width=K,
                      max_len=L, len_penalty_ratio=len_penalty_ratio,
                      pad_id=pad_id, eos_id=eos_id, ref_ties=ref_ties,
                      data_group=data_group)


@torch.no_grad()
@spanned("decode.search")
def beam_search_dual(
    model,                        # ImageSeq2Seq
    enc_text: torch.Tensor,       # [B, S, E] text-encoder states
    text_mask: torch.Tensor,      # [B, S]
    grid: torch.Tensor,           # [B, G, E] image grid
    first_tokens: torch.Tensor,
    tgt_langs: torch.Tensor,
    src_sizes: Optional[torch.Tensor] = None,
    *,
    beam_width: int = 4,
    max_len: int = 128,
    max_len_a: float = 1.3,
    max_len_b: int = 5,
    len_penalty_ratio: float = 0.8,
    pad_id: int = 0,
    eos_id: int = 4,
    grid_mask: Optional[torch.Tensor] = None,
    init_method=None,
    step_method=None,
    ref_ties: bool = True,
    data_group=None,
):
    """Gated dual-stream beam search: every step decodes against the text
    encoding AND the image grid, each stream with its own KV cache, and
    blends the two decoder outputs with the learned gate. Same selection as
    ``beam_search``; both caches follow the selected beams.

    The two streams are generic: ``init_method``/``step_method`` (unbound
    methods of the model's class; default ``init_dual_cache`` /
    ``decode_step_dual``) swap in another pair, e.g.
    ``ImageSeq2Seq.init_obj_dual_cache`` / ``decode_step_obj_dual`` for the
    grid + object decode, with ``enc_text`` = the image grid, ``grid`` = the
    object states and ``grid_mask`` = the valid-detection mask.
    ``data_group`` as in ``beam_search``."""
    B = enc_text.shape[0]
    K, L = beam_width, max_len
    lang_idx = first_lang(tgt_langs)
    if init_method is None:
        init_method = type(model).init_dual_cache
    if step_method is None:
        step_method = type(model).decode_step_dual
    max_lens = _max_lens(src_sizes, B, L, max_len_a, max_len_b,
                         enc_text.device)

    cb_text = pad_bias(text_mask)
    if grid_mask is None:
        cb_img = pad_bias(torch.ones(grid.shape[:2], dtype=torch.bool,
                                     device=grid.device))
    else:
        cb_img = pad_bias(grid_mask)
    langs_k = tgt_langs.repeat_interleave(K, dim=0)
    cache = init_method(model, enc_text, grid, B * K, L, lang_idx)

    def step(prev, index):
        return step_method(model, prev, cache, index, cb_text, cb_img,
                           langs_k, lang_idx, topk=K)

    return _beam_loop(step, list(cache.values()), first_tokens, max_lens,
                      beam_width=K, max_len=L,
                      len_penalty_ratio=len_penalty_ratio, pad_id=pad_id,
                      eos_id=eos_id, ref_ties=ref_ties,
                      data_group=data_group)


def trim_outputs(best, lengths, remove_first_token: bool = False):
    """Host side: list of python int lists, EOS excluded."""
    best = np.asarray(best.cpu() if isinstance(best, torch.Tensor) else best)
    lengths = np.asarray(lengths.cpu() if isinstance(lengths, torch.Tensor)
                         else lengths)
    start = 1 if remove_first_token else 0
    return [[int(t) for t in row[start:int(ln)]]
            for row, ln in zip(best, lengths)]
