"""Adam with inverse-sqrt warmup (port of imagetranslate_tpu/train/optimizer.py).

The JAX package builds an optax chain: global-norm clip -> scale_by_adam(0.9,
0.98, eps 1e-8) -> optional add_decayed_weights -> scale_by_schedule -> -1.
This module writes that update by hand on lists of tensors
(``torch._foreach_*``), in place on the parameters. ``torch.optim.Adam`` is not
used: optax bias-corrects both moments and then adds eps to sqrt(v_hat), and
the schedule has a count of its own, apart from Adam's, which is what
``reset_schedule`` relies on (it restarts the warmup and keeps the moments).

The learning rate used by update k (k updates completed before it) is

    k < warmup:  warmup_init + k * (lr - warmup_init) / warmup
    k >= warmup: clamp(lr * sqrt(warmup) / sqrt(k), warmup_init, lr)

The state mirrors the optax chain's state (``OptState`` holds what
``ScaleByAdamState`` and ``ScaleByScheduleState`` hold; ``MultiStepsState`` is
optax's), so ``train/weights.py`` can write it as ``opt_state.msgpack`` in the
JAX package's layout. Counts are host ints: an update syncs nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.98, 1e-8


def inverse_sqrt_schedule(lr: float, warmup_updates: int = 4000,
                          warmup_init_lr: float = 1e-7) -> Callable[[int],
                                                                    float]:
    """count -> learning rate, in fp32 arithmetic as the JAX schedule."""
    f32 = np.float32
    decay_factor = f32(lr * warmup_updates ** 0.5)
    lr_step = f32((lr - warmup_init_lr) / warmup_updates)

    def schedule(count: int) -> float:
        c = f32(count)
        if c < warmup_updates:
            return float(f32(warmup_init_lr) + c * lr_step)
        decay = decay_factor * (f32(1.0) / np.sqrt(np.maximum(c, f32(1.0))))
        return float(np.clip(decay, f32(warmup_init_lr), f32(lr)))

    return schedule


@dataclasses.dataclass
class OptState:
    """The chain's state: Adam's count and moments (parameter name -> fp32
    tensor) and the schedule's own count."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    schedule_count: int


@dataclasses.dataclass
class MultiStepsState:
    """optax.MultiStepsState: the micro-step within the window, the number of
    inner updates made, the inner state and the running mean gradient."""
    mini_step: int
    gradient_step: int
    inner_opt_state: OptState
    acc_grads: Dict[str, torch.Tensor]


class InverseSqrtAdam:
    """``init(params)`` -> state; ``update(grads, state, params)`` applies one
    update IN PLACE to ``params`` and ``state`` (both dicts of tensors keyed
    by parameter name, ``grads`` in the same order)."""

    def __init__(self, lr: float, warmup_updates: int,
                 clip_norm: Optional[float], weight_decay: float):
        self.clip_norm = clip_norm if clip_norm and clip_norm > 0 else None
        self.weight_decay = float(weight_decay)
        self.schedule = inverse_sqrt_schedule(lr, warmup_updates)
        # The optax chain's members, in order: the positions of the state
        # tuple that opt_state.msgpack numbers.
        self.chain = ((["clip"] if self.clip_norm is not None else [])
                      + ["adam"]
                      + (["decay"] if self.weight_decay > 0 else [])
                      + ["schedule", "scale"])

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        return OptState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                        {k: torch.zeros_like(p) for k, p in params.items()},
                        0)

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: OptState,
               params: Dict[str, torch.Tensor]) -> None:
        ps = list(params.values())
        mu = [state.mu[k] for k in params]
        nu = [state.nu[k] for k in params]
        grads = list(grads)
        if self.clip_norm is not None:
            # optax.clip_by_global_norm: untouched below the limit, else
            # g / norm * limit. No host sync: the factor stays on the device.
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            factor = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                 self.clip_norm / norm)
            grads = torch._foreach_mul(grads, factor)
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - B2)
        state.count += 1
        c1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(state.count))
        c2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(state.count))
        # mu_hat / (sqrt(nu_hat) + eps), eps after both bias corrections
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        step = torch._foreach_div(mu, c1)
        torch._foreach_div_(step, denom)
        if self.weight_decay > 0:
            torch._foreach_add_(step, ps, alpha=self.weight_decay)
        lr = self.schedule(state.schedule_count)
        state.schedule_count += 1
        torch._foreach_add_(ps, step, alpha=-lr)


class MultiSteps:
    """optax.MultiSteps: the running mean of ``every_k`` micro-gradients, one
    inner update on every k-th call, no change to the parameters between."""

    def __init__(self, inner: InverseSqrtAdam, every_k: int):
        self.inner = inner
        self.every_k = int(every_k)

    def init(self, params: Dict[str, torch.Tensor]) -> MultiStepsState:
        return MultiStepsState(
            0, 0, self.inner.init(params),
            {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: MultiStepsState,
               params: Dict[str, torch.Tensor]) -> None:
        acc = [state.acc_grads[k] for k in params]
        # acc += (g - acc) / (mini_step + 1)
        delta = torch._foreach_sub(list(grads), acc)
        torch._foreach_add_(acc, delta, alpha=1.0 / (state.mini_step + 1))
        if state.mini_step == self.every_k - 1:
            self.inner.update(acc, state.inner_opt_state, params)
            torch._foreach_zero_(acc)
            state.mini_step = 0
            state.gradient_step += 1
        else:
            state.mini_step += 1


Optimizer = Union[InverseSqrtAdam, MultiSteps]
AnyOptState = Union[OptState, MultiStepsState]


def build_optimizer(lr: float = 1e-4, warmup_updates: int = 4000,
                    clip_norm: Optional[float] = 1.0,
                    weight_decay: float = 0.0) -> InverseSqrtAdam:
    """Adam(0.9, 0.98) + inverse-sqrt warmup + global-norm clipping."""
    return InverseSqrtAdam(lr, warmup_updates, clip_norm, weight_decay)


def _inner(opt_state: AnyOptState) -> OptState:
    return (opt_state.inner_opt_state
            if isinstance(opt_state, MultiStepsState) else opt_state)


def set_schedule_step(opt_state: AnyOptState, count: int) -> AnyOptState:
    """Set the schedule's count to ``count``, leaving the Adam moments and
    Adam's own count as they are (a restore that rebuilds the optimizer state
    resumes the schedule at the saved step). In place; returns the state."""
    _inner(opt_state).schedule_count = int(count)
    return opt_state


def reset_schedule(opt_state: AnyOptState) -> AnyOptState:
    """Restart the warmup for the fine-tune phase, keeping the moments."""
    return set_schedule_step(opt_state, 0)
