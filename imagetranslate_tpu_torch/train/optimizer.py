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

    # Under a tensor-parallel or pipelined mesh: the model group and the
    # names of the parameters that differ over it (set_tensor_parallel).
    tp_group = None
    tp_sharded: frozenset = frozenset()
    # Under ZeRO-1: the parallel.zero.ZeroLayout whose split parameters'
    # moments are this rank's slices (set_zero).
    zero = None

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
        return OptState(0, _zeros(params, self.zero),
                        _zeros(params, self.zero), 0)

    def set_tensor_parallel(self, group, sharded) -> None:
        """The global-norm clip of a model split over ``group``: the norm's
        square is the group's sum of the split parameters' squares plus the
        replicated ones' counted once (``sharded``: the split parameters'
        names, or a pipeline stage's own layers), so every rank clips by the
        same factor."""
        self.tp_group, self.tp_sharded = group, frozenset(sharded)

    def set_zero(self, layout) -> None:
        """ZeRO-1 (parallel/zero.py): ``update`` then takes this rank's
        slices of the split parameters' gradients (``layout.reduce_grads``),
        keeps slices of their moments (``init``), and all-gathers the
        updated slices into the parameters. Call before ``init``."""
        self.zero = layout

    def _global_norm(self, grads: List[torch.Tensor],
                     names: List[str]) -> torch.Tensor:
        zero = self.zero
        if self.tp_group is None and zero is None:
            return torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        from imagetranslate_tpu_torch.parallel.comm import all_reduce_sum

        def sq(data: bool, model: bool):
            gs = [g for n, g in zip(names, grads)
                  if (zero is not None and zero.split(n)) == data
                  and (n in self.tp_sharded) == model]
            if not gs:
                return torch.zeros((), device=grads[0].device)
            return torch.stack(torch._foreach_norm(gs)).square().sum()

        # The squares of the ZeRO slices summed over the data group, those
        # that differ over the model group summed over it, the rest once.
        sliced = torch.stack([sq(True, True), sq(True, False)])
        if zero is not None:
            sliced = all_reduce_sum(sliced, zero.group)
        split = sq(False, True) + sliced[0]
        if self.tp_group is not None:
            split = all_reduce_sum(split, self.tp_group)
        return torch.sqrt(split + sliced[1] + sq(False, False))

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: OptState,
               params: Dict[str, torch.Tensor]) -> None:
        """``grads``: one per parameter, in ``params``' order; under ZeRO
        this rank's slice of a split parameter's."""
        ps = (list(params.values()) if self.zero is None
              else self.zero.param_slices(params))
        mu = [state.mu[k] for k in params]
        nu = [state.nu[k] for k in params]
        grads = list(grads)
        if self.clip_norm is not None:
            # optax.clip_by_global_norm: untouched below the limit, else
            # g / norm * limit. No host sync: the factor stays on the device.
            norm = self._global_norm(grads, list(params))
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
        if self.zero is not None:
            self.zero.gather_(params, ps)


class MultiSteps:
    """optax.MultiSteps: the running mean of ``every_k`` micro-gradients, one
    inner update on every k-th call, no change to the parameters between."""

    def __init__(self, inner: InverseSqrtAdam, every_k: int):
        self.inner = inner
        self.every_k = int(every_k)

    @property
    def zero(self):
        return self.inner.zero

    def set_tensor_parallel(self, group, sharded) -> None:
        """The inner update's clip (``InverseSqrtAdam.set_tensor_parallel``);
        the running mean is elementwise on each rank's shards."""
        self.inner.set_tensor_parallel(group, sharded)

    def set_zero(self, layout) -> None:
        """ZeRO-1 for the inner update and for the running mean, which then
        holds this rank's slices (JAX shards the accumulation buffer too)."""
        self.inner.set_zero(layout)

    def init(self, params: Dict[str, torch.Tensor]) -> MultiStepsState:
        return MultiStepsState(0, 0, self.inner.init(params),
                               _zeros(params, self.zero))

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


def _zeros(params: Dict[str, torch.Tensor], zero) -> Dict[str, torch.Tensor]:
    """Zeros shaped like each parameter, or like this rank's slice of it
    under ZeRO."""
    if zero is None:
        return {k: torch.zeros_like(p) for k, p in params.items()}
    return {k: torch.zeros_like(zero.local(p.detach(), k))
            for k, p in params.items()}


Optimizer = Union[InverseSqrtAdam, MultiSteps]
AnyOptState = Union[OptState, MultiStepsState]


def build_optimizer(lr: float = 1e-4, warmup_updates: int = 4000,
                    clip_norm: Optional[float] = 1.0,
                    weight_decay: float = 0.0) -> InverseSqrtAdam:
    """Adam(0.9, 0.98) + inverse-sqrt warmup + global-norm clipping."""
    return InverseSqrtAdam(lr, warmup_updates, clip_norm, weight_decay)


def map_moments(opt_state: AnyOptState, fn: Callable) -> AnyOptState:
    """The state with ``fn`` applied to each of its parameter-keyed dicts
    (Adam's moments, the accumulated gradients): a mesh's trainer gathers
    them for a checkpoint and shards a loaded one."""
    if isinstance(opt_state, MultiStepsState):
        return dataclasses.replace(
            opt_state,
            inner_opt_state=map_moments(opt_state.inner_opt_state, fn),
            acc_grads=fn(opt_state.acc_grads))
    return dataclasses.replace(opt_state, mu=fn(opt_state.mu),
                               nu=fn(opt_state.nu))


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
