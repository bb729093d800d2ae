"""Process meshes, the tensor-parallel rule table and batch sharding (port
of imagetranslate_tpu/parallel/mesh.py: init_distributed, parse_mesh,
make_mesh, model_axis_size, _TP_RULES / param_spec, param_shardings,
shard_params, shard_batch_safe, seq_sharding and put_global).

JAX runs one process over many devices; the port runs one process per rank
(``torchrun --nproc-per-node N``). Rank r sits at grid position
(d, m) = (r // n_model, r % n_model), the row-major order of JAX
``make_mesh``'s ``devices.reshape(n_data, n_model)``, so rank r holds the
shard that JAX device r holds. Each rank joins two process groups: its model
group (the ranks of its d) and its data group (the ranks of its m); an axis
of size 1 has no group (None).

Backend: NCCL where every local rank has a card of its own, gloo where ranks
share a card (NCCL refuses two ranks on one device) or run on the CPU. The
choice is made from the device count, not from a caught error, and printed.
Several machines: ``torchrun --nnodes N --node-rank i --master-addr A
--master-port P`` on each (the counterpart of JAX's
``JAX_COORDINATOR_ADDRESS``); each node picks its devices and backend from
its own ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``.

Host staging (JAX ``put_global``): every process builds the same global
batch on the host, and each rank copies only its rows (``host_rows``), so
that a rank moves 1/D of the batch's host-to-device bytes.
"""

from __future__ import annotations

import dataclasses
import os
import re
import warnings
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """A (data, model) grid of ranks as this rank sees it: the sizes, its
    position (d, m), its model and data groups (None for an axis of size 1,
    or where no process group exists, as in the rule-table tests) and its
    device."""
    n_data: int
    n_model: int
    d: int = 0
    m: int = 0
    model_group: object = None
    data_group: object = None
    device: torch.device = torch.device("cpu")

    @property
    def rank(self) -> int:
        """The linear shard index d * n_model + m (JAX device order)."""
        return self.d * self.n_model + self.m


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK % device_count`` for "cuda",
    else ``device`` as given (e.g. "cpu")."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = _env_int("LOCAL_RANK") or 0
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, device="cuda") -> bool:
    """Join the process group of a multi-process run: torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``), or the arguments (tests pass a ``file://`` store so
    that concurrent runs never share a port). Returns False for a single
    process, True once the group is up. ``device``: where this rank computes
    (decides the backend)."""
    if dist.is_initialized():
        return True
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None and (world_size is None or world_size <= 1):
        return False
    dev = rank_device(device)
    local_world = _env_int("LOCAL_WORLD_SIZE") or world_size
    shared = dev.type == "cuda" and torch.cuda.device_count() < local_world
    backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    if (rank or 0) == 0:
        why = ("ranks share a card" if shared
               else "each rank has a card" if backend == "nccl" else "CPU")
        print(f"[dist] {world_size} ranks over {backend} ({why})", flush=True)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device="cuda") -> ProcessMesh:
    """The (n_data, n_model) mesh over every rank of the process group
    (``n_data`` None: the world divided by ``n_model``); every rank must
    call it, in the same order as any other mesh. The product must equal the
    world size."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} "
                         f"ranks; this run has {world}")
    r = dist.get_rank()
    d, m = divmod(r, n_model)
    model_group = data_group = None
    # new_group is collective: every rank creates every group, in order.
    if n_model > 1:
        for dd in range(n_data):
            g = dist.new_group([dd * n_model + mm for mm in range(n_model)])
            if dd == d:
                model_group = g
    if n_data > 1:
        for mm in range(n_model):
            g = dist.new_group([dd * n_model + mm for dd in range(n_data)])
            if mm == m:
                data_group = g
    return ProcessMesh(n_data, n_model, d, m, model_group, data_group,
                       rank_device(device))


def parse_mesh(spec: Optional[str], device="cuda") -> Optional[ProcessMesh]:
    """CLI ``--mesh``: "4x2" -> 4-way data x 2-way model; "8" or "8x1" ->
    pure data parallel; "" / None -> no mesh; "auto" -> every rank on the
    data axis."""
    if not spec:
        return None
    if spec == "auto":
        return make_mesh(device=device)
    match = re.fullmatch(r"(\d+)(?:x(\d+))?", spec)
    if not match:
        raise ValueError(f"bad --mesh spec {spec!r}; expected e.g. 8, 4x2, "
                         "auto")
    return make_mesh(int(match.group(1)), int(match.group(2) or 1), device)


def cli_mesh(spec: Optional[str], device="cuda"
             ) -> Tuple[Optional[ProcessMesh], bool]:
    """A training CLI's ``--mesh``: (the mesh, whether this call joined the
    process group, so that the CLI leaves it at the end; a caller that
    joined it before keeps it). No spec: (None, False). A spec outside a
    multi-process run stops with the torchrun recipe."""
    if not spec:
        return None, False
    joined = not dist.is_initialized()
    if not init_distributed(device=device):
        raise SystemExit("--mesh runs one process a rank: launch with "
                         "torchrun --nproc-per-node N")
    try:
        return parse_mesh(spec, device), joined
    except ValueError as e:
        raise SystemExit(f"--mesh {spec}: {e}") from None


def leave(joined: bool) -> None:
    """The end of a CLI run that ``cli_mesh`` joined to the group."""
    if joined:
        dist.destroy_process_group()


def model_axis_size(mesh: Optional[ProcessMesh]) -> int:
    return 1 if mesh is None else mesh.n_model


# The tensor-parallel rules on the port's state_dict names (the HF-2.9 keys;
# JAX _TP_RULES on the flax paths): (pattern, the sharded dim, whether the
# dim counts heads of ``head_dim`` rows). QKV weights [H D, E] and biases
# shard their heads, the attention output [E, H D] its input heads, the FFN
# intermediate [F, E] and bias F, the FFN output [E, F] its input F, the word
# embedding [V, E] and the untied vocab projection [V, E] and bias V. The
# attention-output and FFN-output biases, LayerNorms, position and language
# embeddings, the proposal gate and the tied output bias are replicated.
# Expert parallelism: an MoE bank's stacked experts (wi [E, H, F], bi [E, F],
# wo [E, F, H], bo [E, H]) split their expert dim; its fp32 router and its
# LayerNorm stay replicated.
_TP_RULES = [
    (r"\.moe\.(wi|bi|wo|bo)$", 0, False),
    (r"\.self\.(query|key|value)\.(weight|bias)$", 0, True),
    (r"attention\.output\.dense\.weight$", 1, True),
    (r"\.intermediate\.dense\.(weight|bias)$", 0, False),
    (r"\.output\.dense\.weight$", 1, False),
    (r"word_embeddings\.weight$", 0, False),
    (r"output_layer(\.\d+)?\.layer\.weight$", 0, False),
    (r"output_layer(\.\d+)?\.layer\.bias$", 0, False),
]
_TIED_BIAS = r"output_layer(\.\d+)?\.layer\.bias$"

Plan = Dict[str, Optional[int]]   # state_dict key -> sharded dim or None


def param_spec(name: str, tie_embed: bool = False
               ) -> Optional[Tuple[int, bool]]:
    """(dim, counts heads) of the rule that shards ``name``, or None
    (replicated). With ``tie_embed`` the output bias is the replicated
    ``out_bias`` of the JAX model."""
    if tie_embed and re.search(_TIED_BIAS, name):
        return None
    for pattern, dim, heads in _TP_RULES:
        if re.search(pattern, name):
            return dim, heads
    return None


def shard_plan(shapes: Mapping[str, Tuple[int, ...]], mesh: ProcessMesh,
               cfg) -> Plan:
    """The dim each tensor shards over the model axis, or None. A dim the
    axis does not divide (in heads, for the attention rules) falls back to
    replication, LOUDLY: the layer then runs as pure data parallelism.
    An MoE bank splits its experts (expert parallelism)."""
    n = mesh.n_model
    plan: Plan = {}
    fallbacks = []
    for name, shape in shapes.items():
        spec = param_spec(name, cfg.tie_embed) if n > 1 else None
        if spec is None:
            plan[name] = None
            continue
        dim, heads = spec
        unit = cfg.head_dim if heads else 1
        if dim >= len(shape) or shape[dim] % (unit * n):
            fallbacks.append((name, tuple(shape), dim))
            plan[name] = None
        else:
            plan[name] = dim
    if fallbacks:
        lines = "\n".join(f"  {p} shape={s} wanted dim {d}"
                          for p, s, d in fallbacks[:8])
        warnings.warn(
            f"{len(fallbacks)} tensor-parallel params fell back to "
            f"replication (dims not divisible by the model axis); this mesh "
            f"runs those layers as pure data parallel:\n{lines}",
            stacklevel=2)
    return plan


def shard_params(state_dict: Mapping[str, torch.Tensor], mesh: ProcessMesh,
                 plan: Plan) -> Dict[str, torch.Tensor]:
    """This rank's shard of a full state dict (or of any dict of tensors
    keyed like it: the Adam moments): slice m of n_model along each planned
    dim, the rest as it is. A slice is a copy: it holds no reference to the
    full tensor, and starts on an aligned address, as the kernels ask."""
    out = {}
    for name, t in state_dict.items():
        dim = plan.get(name)
        if dim is None:
            out[name] = t
        else:
            out[name] = t.chunk(mesh.n_model, dim=dim)[mesh.m].clone(
                memory_format=torch.contiguous_format)
    return out


def gather_params(state_dict: Mapping[str, torch.Tensor], mesh: ProcessMesh,
                  plan: Plan) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_params``, collective over the model group:
    every rank gets the full tensors (on their device)."""
    from imagetranslate_tpu_torch.parallel.comm import all_gather_stack

    out = {}
    for name, t in state_dict.items():
        dim = plan.get(name)
        if dim is None:
            out[name] = t
        else:
            parts = all_gather_stack(t.detach(), mesh.model_group)
            out[name] = torch.cat(list(parts), dim=dim)
    return out


def shard_module_(module, mesh: ProcessMesh, plan: Plan) -> None:
    """Keep this rank's shard of every parameter of ``module`` that the
    plan splits (in place; the values are kept: load a full state through
    ``shard_params`` afterwards), and tell each layer what it holds: an
    ``Attention`` whose heads are split, an ``EncoderLayer`` whose FFN is
    split, an ``Embeddings`` whose word rows are split (their ``tp``), an
    MoE bank its experts (``tp``) and the data group it routes over
    (``dp``). ``Seq2Seq``, ``LM``, ``SenSim``, ``Caption2Image`` and the
    captioner's text core share it."""
    from imagetranslate_tpu_torch.models.moe import MoEFeedForward
    from imagetranslate_tpu_torch.models.transformer import (
        Attention,
        Embeddings,
        EncoderLayer,
    )

    sd = module.state_dict()
    local = shard_params({k: sd[k] for k, d in plan.items()
                          if d is not None and k in sd}, mesh, plan)
    for name, param in module.named_parameters():
        if plan.get(name) is not None:
            param.data = local[name]

    def split(key):
        return mesh if plan.get(key) is not None else None

    for name, mod in module.named_modules():
        pre = name + "." if name else ""
        if isinstance(mod, Attention):
            mod.tp = split(pre + "self.query.weight")
        elif isinstance(mod, EncoderLayer):
            mod.tp = split(pre + "intermediate.dense.weight")
        elif isinstance(mod, Embeddings):
            mod.tp = split(pre + "word_embeddings.weight")
        elif isinstance(mod, MoEFeedForward):
            mod.tp = split(pre + "wi")
            mod.dp = mesh if mesh.data_group is not None else None


def module_plan(module, mesh: ProcessMesh, cfg) -> Plan:
    """``shard_plan`` over a module's state_dict."""
    return shard_plan({k: tuple(v.shape)
                       for k, v in module.state_dict().items()}, mesh, cfg)


def seq_range(mesh: ProcessMesh, seq_len: int, block: int) -> Tuple[int, int]:
    """[lo, hi) of the positions rank (d, m) holds under sequence
    parallelism (JAX ``seq_sharding``: the model axis splits the sequence
    dim, the data axis the rows): the m-th contiguous run of whole
    ``block``s. The blocks must divide evenly over the model axis (GSPMD
    would accept an uneven split; the port refuses it)."""
    n = mesh.n_model
    if seq_len % block or (seq_len // block) % n:
        raise ValueError(
            f"sequence parallelism over {n} ranks needs the {seq_len} "
            f"positions to split into whole {block}-token blocks, the same "
            f"number on every rank ({seq_len // block} blocks do not)")
    run = seq_len // n
    return mesh.m * run, (mesh.m + 1) * run


def host_rows(n_rows: int, mesh: Optional[ProcessMesh]) -> slice:
    """The rows of an ``n_rows``-row host array that this rank stages
    (JAX ``put_global``: each process uploads only its own shard): the
    rows of its data index, or all of them without a data group or where
    the data axis does not divide them (``shard_batch_safe``'s rule)."""
    if mesh is None or mesh.n_data == 1:
        return slice(None)
    if n_rows % mesh.n_data:
        warnings.warn(
            f"host_rows: {n_rows} rows, not divisible by the data axis "
            f"({mesh.n_data}); replicating — data parallelism is lost for "
            "this shape", stacklevel=2)
        return slice(None)
    rows = n_rows // mesh.n_data
    return slice(mesh.d * rows, (mesh.d + 1) * rows)


def shard_batch_safe(batch: Mapping[str, torch.Tensor], mesh: ProcessMesh
                     ) -> Dict[str, torch.Tensor]:
    """The rows of this rank's data index of every array (a tensor, or a
    numpy array on the host before its copy) with a leading dim. An array
    whose rows the data axis does not divide stays whole on every rank (the
    step's global sum / count still counts it right: every data rank adds
    the same sums), with a warning once per (key, rows), and is listed
    under ``"_whole"`` (the InfoNCE steps gather only the split ones)."""
    n = mesh.n_data
    out = {}
    whole = set(batch.get("_whole", ()))
    for k, v in batch.items():
        if getattr(v, "ndim", 0) < 1 or n == 1 or k == "_whole":
            out[k] = v
        elif v.shape[0] % n == 0:
            rows = v.shape[0] // n
            out[k] = v[mesh.d * rows:(mesh.d + 1) * rows]
        else:
            if v.ndim >= 2:
                warnings.warn(
                    f"shard_batch_safe: batch[{k!r}] has {v.shape[0]} rows, "
                    f"not divisible by the data axis ({n}); replicating — "
                    "data parallelism is lost for this shape", stacklevel=2)
            out[k] = v
            whole.add(k)
    if whole:
        out["_whole"] = frozenset(whole)
    return out
