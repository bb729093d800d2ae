"""ZeRO-1: the optimizer state split over the data group (port of
imagetranslate_tpu/parallel/mesh.py: ``zero_shard_opt_state`` and
``zero_opt_shardings``).

The placement is JAX's, leaf for leaf. JAX gives a moment tensor of at least
``min_size`` elements the data axis on its first dim that no other axis
splits (the tensor-parallel dim of ``parallel/mesh.py::shard_plan`` is
taken) and that the data axis divides; smaller tensors and tensors without
such a dim stay whole on every rank. The dims are those of the flax layout,
which differs from the port's ``state_dict`` layout: a Linear weight is
[out, in] here and [in, out] there, a query / key / value weight [H D, E]
here and [E, H, D] there, an attention output weight [E, H D] here and
[H, D, E] there, a router [E, H] here and [H, E] there. So each tensor is
seen through its flax dims (``flax_view``: a reshape that unfolds H D, and
the order of the flax dims), and JAX's rule picks one of them.

In JAX the placement is all: XLA turns the gradient all-reduce into a
reduce-scatter and an all-gather. Here the step does it by hand
(``ZeroLayout``): the gradients of the split tensors are reduce-scattered
over the data group (the others all-reduced, as without ZeRO), each rank
updates its slice of the parameters with its slices of Adam's moments (and of
``MultiSteps``' running mean under gradient accumulation), and the data
group all-gathers the updated slices into every rank's parameters. A slice
is flat: the tensor in flax order with the split dim moved first, cut into
``n_data`` equal runs; rank d holds run d, the elements of JAX's shard d.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from imagetranslate_tpu_torch.parallel.comm import (
    all_gather_flat,
    all_reduce_sum,
    reduce_scatter_sum,
)

MIN_SIZE = 4096

# (pattern, how the flax layout reads the port's tensor): "qkv" [H D, E] ->
# [E, H, D]; "qkv_bias" [H D] -> [H, D]; "attn_out" [E, H D] -> [H, D, E];
# "linear" [out, in] -> [in, out]; "conv" (the captioner's ResNet)
# [out, in, kh, kw] -> [kh, kw, in, out]; anything else is laid out alike.
_VIEWS = [
    (r"\.self\.(query|key|value)\.weight$", "qkv"),
    (r"\.self\.(query|key|value)\.bias$", "qkv_bias"),
    (r"attention\.output\.dense\.weight$", "attn_out"),
    (r"(\.dense|output_layer(\.\d+)?\.layer|\.router)\.weight$", "linear"),
    (r"(^|\.)(fc|object_feat_fc|w)\.weight$", "linear"),
    (r"(^|\.)(conv\d|downsample\.0)\.weight$", "conv"),
]


def flax_view(name: str, shape: Sequence[int], head_dim: int
              ) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
    """(factor shape, flax order, torch dim of each factor) of the port's
    tensor ``name`` of ``shape``: ``t.reshape(factor shape).permute(flax
    order)`` is the tensor in the flax layout."""
    kind = next((k for pattern, k in _VIEWS if re.search(pattern, name)),
                None)
    shape = tuple(int(s) for s in shape)
    if kind == "qkv":
        return (shape[0] // head_dim, head_dim, shape[1]), (2, 0, 1), (0, 0, 1)
    if kind == "qkv_bias":
        return (shape[0] // head_dim, head_dim), (0, 1), (0, 0)
    if kind == "attn_out":
        return (shape[0], shape[1] // head_dim, head_dim), (1, 2, 0), (0, 1, 1)
    if kind == "linear" and len(shape) == 2:
        return shape, (1, 0), (0, 1)
    if kind == "conv" and len(shape) == 4:
        return shape, (2, 3, 1, 0), (0, 1, 2, 3)
    return shape, tuple(range(len(shape))), tuple(range(len(shape)))


def zero_flax_dim(name: str, shape: Sequence[int], taken: Optional[int],
                  n_split: int, n_data: int, head_dim: int,
                  min_size: int = MIN_SIZE) -> Optional[int]:
    """The flax dim JAX's ``zero_opt_shardings`` gives the data axis for the
    moments of ``name`` (its ``shape`` on this rank, ``n_split`` such shards
    making the whole; ``taken``: the port's dim the model axis is named on,
    or None), or None: the moments stay whole."""
    if n_data <= 1 or len(shape) < 1:
        return None
    numel = 1
    for s in shape:
        numel *= int(s)
    if numel * n_split < min_size:
        return None
    factors, order, torch_dim = flax_view(name, shape, head_dim)
    # The model axis's dim is the first factor of the torch dim it names
    # (the heads of H D).
    taken = None if taken is None else torch_dim.index(taken)
    for fd, f in enumerate(order):
        if f != taken and factors[f] % n_data == 0:
            return fd
    return None


class ZeroLayout:
    """Which parameters' optimizer state this rank holds a slice of, and the
    collectives of the ZeRO-1 step over ``mesh.data_group``. ``shapes``: the
    rank's parameter shapes (its tensor-parallel shards or pipeline stage);
    ``plan``: the tensor-parallel plan (None: the model axis splits nothing,
    as under the pipeline). JAX names the model axis on a tensor's rule dim
    even where that axis has size 1, and not where a dim it does not divide
    fell back to replication: that dim is not the data axis's to take."""

    def __init__(self, shapes: Mapping[str, Sequence[int]], mesh, cfg,
                 plan: Optional[Mapping[str, Optional[int]]] = None,
                 min_size: int = MIN_SIZE):
        from imagetranslate_tpu_torch.parallel.mesh import param_spec

        self.group = mesh.data_group
        self.n, self.d = mesh.n_data, mesh.d
        self.flax_dims: Dict[str, Optional[int]] = {}
        self._views: Dict[str, Tuple[Tuple[int, ...], int]] = {}
        for name, shape in shapes.items():
            split = None if plan is None else plan.get(name)
            if plan is None:
                taken = None
            elif mesh.n_model == 1:
                spec = param_spec(name, cfg.tie_embed)
                taken = None if spec is None else spec[0]
            else:
                taken = split
            fd = zero_flax_dim(name, shape, taken,
                               mesh.n_model if split is not None else 1,
                               self.n, cfg.head_dim, min_size)
            self.flax_dims[name] = fd
            if fd is not None:
                factors, order, _ = flax_view(name, shape, cfg.head_dim)
                self._views[name] = (factors, order[fd])

    def split(self, name: str) -> bool:
        return name in self._views

    def _runs(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """[n_data, numel / n_data]: the tensor's runs, run d rank d's."""
        factors, f = self._views[name]
        return t.reshape(factors).movedim(f, 0).reshape(self.n, -1)

    def _unruns(self, runs: torch.Tensor, name: str,
                shape: Sequence[int]) -> torch.Tensor:
        factors, f = self._views[name]
        moved = (factors[f],) + factors[:f] + factors[f + 1:]
        return runs.reshape(moved).movedim(0, f).reshape(shape)

    def local(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's slice of ``t`` (a copy) where ``name`` is split, else
        ``t``."""
        if not self.split(name):
            return t
        return self._runs(t, name)[self.d].clone()

    def local_dict(self, sd: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        return {k: self.local(v, k) for k, v in sd.items()}

    def full_dict(self, sd: Mapping[str, torch.Tensor],
                  shapes: Mapping[str, Sequence[int]]
                  ) -> Dict[str, torch.Tensor]:
        """The whole tensors of a dict of slices (``shapes``: the whole
        shapes); collective over the data group."""
        out = {}
        for k, v in sd.items():
            if self.split(k):
                runs = all_gather_flat(v.reshape(-1), self.group)
                v = self._unruns(runs, k, shapes[k])
            out[k] = v
        return out

    def reduce_grads(self, grads: List[torch.Tensor], names: Sequence[str]
                     ) -> List[torch.Tensor]:
        """The gradients summed over the data group: this rank's slice of a
        split parameter's (one reduce-scatter for all of them), the whole of
        the others' (one all-reduce)."""
        split = [i for i, k in enumerate(names) if self.split(k)]
        whole = [i for i, k in enumerate(names) if not self.split(k)]
        out = list(grads)
        if split:
            runs = torch.cat([self._runs(grads[i], names[i]) for i in split],
                             dim=1)
            mine = reduce_scatter_sum(runs.reshape(-1), self.group)
            sizes = [grads[i].numel() // self.n for i in split]
            for i, s in zip(split, mine.split(sizes)):
                out[i] = s
        if whole:
            flat = all_reduce_sum(torch.cat([grads[i].reshape(-1)
                                             for i in whole]), self.group)
            for i, f in zip(whole, flat.split([grads[i].numel()
                                               for i in whole])):
                out[i] = f.view_as(grads[i])
        return out

    def param_slices(self, params: Mapping[str, torch.Tensor]
                     ) -> List[torch.Tensor]:
        """What the update changes: this rank's slice (a copy) of a split
        parameter, the parameter itself otherwise."""
        return [self.local(p.detach(), k) for k, p in params.items()]

    @torch.no_grad()
    def gather_(self, params: Mapping[str, torch.Tensor],
                slices: List[torch.Tensor]) -> None:
        """Write the updated slices of every rank into the split parameters
        (one all-gather)."""
        names = [k for k in params if self.split(k)]
        if not names:
            return
        mine = torch.cat([s.reshape(-1) for k, s in zip(params, slices)
                          if self.split(k)])
        runs = all_gather_flat(mine, self.group).reshape(self.n, -1)
        sizes = [params[k].numel() // self.n for k in names]
        for k, part in zip(names, runs.split(sizes, dim=1)):
            params[k].copy_(self._unruns(part, k, params[k].shape))
