"""MASS span masking and BERT MLM masking on the batch's device (port of
imagetranslate_tpu/ops/masking.py).

Per row of length L (the index of its first pad):

- span length = L // 2 (``mask_prob`` only bounds where the span may start);
- span start: 20% of rows at 1, 20% at last_idx = max(ceil(mask_prob * L),
  2) (in float32), 60% uniform in [2, last_idx] inclusive; then clamped so
  that the span stays inside the row (start <= L - 1,
  end = min(start + L // 2, L), also when ``mask_prob`` > 0.5 puts
  start + L // 2 past L);
- span tokens corrupted 80/10/10: <mask> / a random non-special token /
  unchanged;
- decoder input = [token before the span] + span, padded to ``span_width``
  (>= S // 2 + 1), with explicit position ids; padded slots carry ``pad_id``
  and position S - 1.

MLM masking (``mask_text``): each non-pad position is selected with
probability ``mask_prob`` and corrupted 80/10/10.

Each function is split in two. ``draw_mass`` / ``draw_mlm`` draw the random
numbers from a ``torch.Generator`` on the batch's device; ``mass_mask_core``
/ ``mask_text_core`` are deterministic functions of the batch and the draws,
equal to the JAX functions element for element when fed JAX's draws. All of
it is tensor code on the device: no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class MassMasked(NamedTuple):
    src: torch.Tensor          # [B, S] corrupted source
    dec_inputs: torch.Tensor   # [B, W] token before the span + the span
    positions: torch.Tensor    # [B, W] explicit decoder position ids
    span_mask: torch.Tensor    # [B, S] True where corrupted


class MassDraws(NamedTuple):
    kind: torch.Tensor         # [B] uniform [0, 1): picks the start rule
    rand_start: torch.Tensor   # [B] int, uniform in [2, last_idx]
    u: torch.Tensor            # [B, S] uniform [0, 1): the 80/10/10 choice
    rand_tok: torch.Tensor     # [B, S] int, uniform in [n_specials, vocab)


class MLMMasked(NamedTuple):
    texts: torch.Tensor        # [B, S] corrupted
    target_mask: torch.Tensor  # [B, S] True at masked (loss) positions


class MLMDraws(NamedTuple):
    sel: torch.Tensor          # [B, S] uniform [0, 1): selects positions
    u: torch.Tensor            # [B, S]
    rand_tok: torch.Tensor     # [B, S]


def _last_idx(lengths: torch.Tensor, mask_prob) -> torch.Tensor:
    """max(ceil(L * mask_prob), 2), the product in float32 as the JAX step
    takes it: ``mask_prob`` (a float or a 0-dim tensor) is rounded to
    float32 first, so that a start at the boundary of a ceil is the
    same."""
    if isinstance(mask_prob, torch.Tensor):
        mask_prob = mask_prob.to(torch.float32)
    else:
        mask_prob = float(np.float32(mask_prob))
    last = torch.ceil(lengths.to(torch.float32) * mask_prob).to(torch.int32)
    return torch.clamp(last, min=2)


def _draw_corrupt(gen: torch.Generator, shape, n_specials: int,
                  vocab_size: int, device):
    u = torch.rand(shape, generator=gen, device=device)
    rand_tok = torch.randint(n_specials, vocab_size, shape, generator=gen,
                             device=device, dtype=torch.int32)
    return u, rand_tok


def _corrupt(tokens, mask, u, rand_tok, mask_id: int):
    """80/10/10 corruption of ``tokens`` where ``mask``."""
    rand_tok = rand_tok.to(tokens.dtype)
    corrupted = torch.where(u < 0.8, mask_id,
                            torch.where(u < 0.9, rand_tok, tokens))
    return torch.where(mask, corrupted, tokens)


def draw_mass(gen: torch.Generator, src: torch.Tensor, lengths: torch.Tensor,
              mask_prob: float, *, n_specials: int,
              vocab_size: int) -> MassDraws:
    """The random numbers of one ``mass_mask`` call, from ``gen`` (a
    generator on ``src``'s device)."""
    B = src.shape[0]
    dev = src.device
    kind = torch.rand((B,), generator=gen, device=dev)
    # Uniform over the 1 + last_idx - 2 integers of [2, last_idx], per row.
    span = (_last_idx(lengths, mask_prob) - 1).to(torch.float32)
    r = torch.rand((B,), generator=gen, device=dev)
    rand_start = 2 + torch.minimum(torch.floor(r * span), span - 1).to(
        torch.int32)
    u, rand_tok = _draw_corrupt(gen, src.shape, n_specials, vocab_size, dev)
    return MassDraws(kind, rand_start, u, rand_tok)


def mass_mask_core(draws: MassDraws, src: torch.Tensor, lengths: torch.Tensor,
                   mask_prob: float, *, mask_id: int, pad_id: int,
                   span_width: int) -> MassMasked:
    """The deterministic part of ``mass_mask``. src [B, S] ids; lengths [B]
    index of the first pad; ``span_width`` the output width, >= S // 2 + 1."""
    S = src.shape[1]
    dev = src.device
    lengths = lengths.to(torch.int32)
    range_size = lengths // 2
    last_idx = _last_idx(lengths, mask_prob)

    kind = draws.kind
    start = torch.where(kind > 0.8, 1,
                        torch.where(kind > 0.6, last_idx,
                                    draws.rand_start.to(torch.int32)))
    start = torch.minimum(start, torch.clamp(lengths - 1, min=1))
    end = torch.minimum(start + range_size, lengths)

    pos = torch.arange(S, device=dev, dtype=torch.int32)[None, :]
    span_mask = (pos >= start[:, None]) & (pos < end[:, None])
    corrupted = _corrupt(src, span_mask, draws.u, draws.rand_tok, mask_id)

    # Token at start - 1, then the span, padded to span_width.
    at = start[:, None] - 1 + torch.arange(span_width, device=dev,
                                           dtype=torch.int32)[None, :]
    gather_idx = torch.clamp(at, 0, S - 1)
    valid = at < end[:, None]
    dec_inputs = torch.where(valid, torch.gather(src, 1, gather_idx.long()),
                             pad_id)
    positions = torch.where(valid, gather_idx, S - 1)
    return MassMasked(corrupted, dec_inputs, positions, span_mask)


def mass_mask(gen: torch.Generator, src: torch.Tensor, lengths: torch.Tensor,
              mask_prob: float, *, mask_id: int, pad_id: int, n_specials: int,
              vocab_size: int, span_width: int) -> MassMasked:
    draws = draw_mass(gen, src, lengths, mask_prob, n_specials=n_specials,
                      vocab_size=vocab_size)
    return mass_mask_core(draws, src, lengths, mask_prob, mask_id=mask_id,
                          pad_id=pad_id, span_width=span_width)


def draw_mlm(gen: torch.Generator, texts: torch.Tensor, *, n_specials: int,
             vocab_size: int) -> MLMDraws:
    sel = torch.rand(texts.shape, generator=gen, device=texts.device)
    u, rand_tok = _draw_corrupt(gen, texts.shape, n_specials, vocab_size,
                                texts.device)
    return MLMDraws(sel, u, rand_tok)


def mask_text_core(draws: MLMDraws, texts: torch.Tensor,
                   pad_mask: torch.Tensor, mask_prob: float, *, mask_id: int,
                   eos_id: int, mask_eos: bool = True) -> MLMMasked:
    sel = (draws.sel < mask_prob) & pad_mask
    if not mask_eos:
        sel = sel & (texts != eos_id)
    return MLMMasked(_corrupt(texts, sel, draws.u, draws.rand_tok, mask_id),
                     sel)


def mask_text(gen: torch.Generator, texts: torch.Tensor,
              pad_mask: torch.Tensor, mask_prob: float, *, mask_id: int,
              eos_id: int, n_specials: int, vocab_size: int,
              mask_eos: bool = True) -> MLMMasked:
    """BERT-style MLM corruption."""
    draws = draw_mlm(gen, texts, n_specials=n_specials, vocab_size=vocab_size)
    return mask_text_core(draws, texts, pad_mask, mask_prob, mask_id=mask_id,
                          eos_id=eos_id, mask_eos=mask_eos)
