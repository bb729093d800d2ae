"""The collectives of the port's data and tensor parallelism, over one
``torch.distributed`` process group (a mesh's model or data group).

The JAX package inserts no communication by hand: XLA places it from the
sharding annotations. The port runs one process per rank and calls these
where the JAX program's collectives sit. ``group=None`` means no group (a
mesh axis of size 1): each function then returns its input.

``tp_copy`` and ``tp_reduce`` carry the tensor-parallel layers' gradients:
the input of a layer whose weight is split by output rows reaches every rank
whole, so its gradient is the sum of the ranks' partial gradients
(``tp_copy``: identity forward, all_reduce backward); the output of a layer
whose weight is split by input columns is the sum of the ranks' partial
products (``tp_reduce``: all_reduce forward, identity backward).

ZeRO-1 (parallel/zero.py) reduce-scatters gradients and all-gathers the
updated parameter slices over the data group (``reduce_scatter_sum``,
``all_gather_flat``); the GPipe schedule (parallel/pipeline.py) moves
activations and their gradients between neighbouring stages (``send``,
``recv``). Over NCCL these are the native collectives on the card. Gloo, on
the card machine's torch, aborts the process (``gloo::IoException``) when
asked for one of them on CUDA tensors, where its ``all_reduce`` works: under
gloo a CUDA tensor goes through host memory for these four (ranks that share
one card, whose speed nobody reads), and a CPU tensor takes gloo's own.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group, in place; returns ``x``. Over gloo a
    16-bit float tensor is summed in fp32 and rounded once, whatever 16-bit
    support the installed gloo has (NCCL sums it in its own type)."""
    if group_size(group) == 1:
        return x
    if x.dtype in (torch.bfloat16, torch.float16) and \
            dist.get_backend(group) != "nccl":
        wide = x.to(torch.float32)
        dist.all_reduce(wide, op=dist.ReduceOp.SUM, group=group)
        return x.copy_(wide)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max of ``x`` over the group, in place; returns ``x``."""
    if group_size(group) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """[n, *x.shape]: slot i holds the ``x`` of the group's rank i. NCCL
    gathers; gloo (which may refuse ``all_gather`` on CUDA tensors) sums a
    zero buffer in which each rank filled its own slot, exact for floats and
    ints, on the tensors' own device."""
    n = group_size(group)
    if n == 1:
        return x[None]
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        out = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    out = torch.zeros((n, *x.shape), dtype=x.dtype, device=x.device)
    out[group_rank(group)] = x
    return all_reduce_sum(out, group)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_copy(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over the group."""
    return x if group is None else _Copy.apply(x, group)


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group forward; the gradient passed through."""
    return x if group is None else _Reduce.apply(x, group)


# The single-tensor collectives under their newer names where this torch has
# them (2.13 deprecates the old ones; the card machine's 2.11 has only those).
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _via_host(x: torch.Tensor, group) -> bool:
    """Must ``x`` cross the group through host memory (gloo, CUDA)?"""
    return x.is_cuda and dist.get_backend(group) != "nccl"


def reduce_scatter_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [n * c] (n the group's size) summed over the group; rank i of
    the group gets elements [i * c, (i + 1) * c) of the sum, a new tensor."""
    n = group_size(group)
    if n == 1:
        return x
    host = _via_host(x, group)
    src = x.detach().contiguous().cpu() if host else x.detach().contiguous()
    out = src.new_empty(src.numel() // n)
    _REDUCE_SCATTER(out, src, group=group)
    return out.to(x.device) if host else out


def all_gather_flat(x: torch.Tensor, group) -> torch.Tensor:
    """[n * c]: the ``x`` [c] of the group's rank i at [i * c, (i + 1) * c)."""
    n = group_size(group)
    if n == 1:
        return x
    host = _via_host(x, group)
    src = x.detach().contiguous().cpu() if host else x.detach().contiguous()
    out = src.new_empty(src.numel() * n)
    _ALL_GATHER(out, src, group=group)
    return out.to(x.device) if host else out


def send(x: torch.Tensor, dst: int) -> None:
    """Send ``x`` to global rank ``dst`` (blocking)."""
    host = _via_host(x, None)
    dist.send(x.detach().contiguous().cpu() if host
              else x.detach().contiguous(), dst)


def recv(shape, dtype: torch.dtype, device, src: int) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` from global rank ``src``, on
    ``device``."""
    device = torch.device(device)
    host = device.type == "cuda" and dist.get_backend() != "nccl"
    out = torch.empty(shape, dtype=dtype,
                      device="cpu" if host else device)
    dist.recv(out, src)
    return out.to(device) if host else out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_stack(x.contiguous(), group).flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        n = group_size(ctx.group)
        total = all_reduce_sum(g.contiguous().clone(), ctx.group)
        return total.chunk(n)[group_rank(ctx.group)].contiguous(), None


class _ReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.group), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The rows of every rank of the group, in rank order ([n * B, ...]
    from each rank's [B, ...]); backward: each rank takes its own rows of
    the group's summed gradient. The contrastive losses gather their
    vectors through it: every rank's loss reads every rank's rows."""
    return x if group is None else _GatherRows.apply(x, group)


def all_reduce_autograd(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group forward, and the gradient summed over the group
    backward (every rank's output reads every rank's input): the global
    batch statistics of BatchNorm. Not ``tp_reduce``, whose backward is the
    identity."""
    return x if group is None else _ReduceBoth.apply(x, group)
