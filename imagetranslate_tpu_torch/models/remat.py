"""Recompute in the backward pass, the counterpart of the JAX package's
``nn.remat`` of a layer (``cfg.remat``) or of the FFN (``cfg.remat_ffn``):
the block's activations are not kept after its forward, and the backward
runs the block again to get them (``torch.utils.checkpoint``,
non-reentrant).

The dropout stream does not replay by itself: a ``DropoutRng`` draws the
fused attention kernel's seeds from a host generator and the elementwise
masks from a device generator, neither of which ``torch.utils.checkpoint``
saves. ``checkpointed`` takes both generators' states before the forward,
puts them back for the recompute (the same seeds, the same masks, the same
bits) and afterwards returns them to where the stream stood, so the layers
after it draw what they would draw without recompute. A recompute also must
not report an MoE load-balance loss a second time: ``recomputing()`` is true
while one runs.
"""

from __future__ import annotations

import contextlib

from torch.utils.checkpoint import checkpoint

_depth = 0      # > 0 while a checkpointed block runs again in the backward


def recomputing() -> bool:
    return _depth > 0


@contextlib.contextmanager
def _replay(drop, before):
    global _depth
    after = None if drop is None else drop.get_state()
    if drop is not None:
        drop.set_state(before)
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1
        if drop is not None:
            drop.set_state(after)


def checkpointed(fn, drop, *args):
    """``fn(*args, drop)`` with its activations recomputed in the backward,
    the dropout stream ``drop`` (a DropoutRng or None) replayed there."""
    before = None if drop is None else drop.get_state()
    return checkpoint(
        fn, *args, drop, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _replay(drop, before)))
