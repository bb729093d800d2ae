"""Rank functions for tests/test_torch_port_parallel.py and
tests/test_torch_port_k2b.py: each runs in a process of its own, spawned by
``imagetranslate_tpu_torch.parallel.spawn.run_ranks`` and joined to its
peers over gloo on the CPU. This module imports torch and the port only
(never JAX), so that the ranks start quickly; inputs and results are numpy
arrays."""

import numpy as np
import torch

from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
from imagetranslate_tpu_torch.parallel.comm import group_rank
from imagetranslate_tpu_torch.parallel.mesh import (
    gather_params,
    make_mesh,
    shard_batch_safe,
    shard_params,
)
from imagetranslate_tpu_torch.train.weights import state_dict_from_flax


def _sharded_model(cfg: Seq2SeqConfig, params, mesh, param_dtype=None):
    model = Seq2Seq(cfg, param_dtype=param_dtype)
    plan = model.shard_(mesh)
    model.load_state_dict(shard_params(state_dict_from_flax(params, cfg),
                                       mesh, plan))
    return model.eval(), plan


def k2b(rank, cases, k):
    """K2b over a 1 x world mesh for each (h, w [V, E], b [V]) of
    ``cases``, the full weights: each rank takes its rows."""
    from imagetranslate_tpu_torch.ops.topk_project import sharded_project_topk

    torch.set_num_threads(1)
    mesh = make_mesh(1, torch.distributed.get_world_size(), device="cpu")
    assert group_rank(mesh.model_group) == mesh.m
    out = []
    for h, w, b in cases:
        w_local = torch.tensor(w).chunk(mesh.n_model)[mesh.m]
        b_local = torch.tensor(b).chunk(mesh.n_model)[mesh.m]
        out.append([t.numpy() for t in sharded_project_topk(
            torch.tensor(h), w_local, b_local, k, mesh.model_group)])
    return out


def project_topk(rank, cases, k):
    """Seq2Seq.project_topk under a 1 x world mesh for each (cfg, params,
    h) of ``cases``."""
    torch.set_num_threads(1)
    mesh = make_mesh(1, torch.distributed.get_world_size(), device="cpu")
    out = []
    for cfg, params, h in cases:
        model, _ = _sharded_model(cfg, params, mesh)
        with torch.no_grad():
            out.append([t.numpy() for t in model.project_topk(
                torch.tensor(h), k)])
    return out


def train_step(rank, cfg, params, batch, meshes, lr, warmup, clip):
    """One MT step from ``params`` under each (n_data, n_model) of
    ``meshes``; per mesh the global loss sum and count and the gathered
    updated parameters and Adam first moments."""
    from imagetranslate_tpu_torch.train.optimizer import build_optimizer
    from imagetranslate_tpu_torch.train.step import (
        create_train_state,
        make_mt_train_step,
    )

    torch.set_num_threads(1)
    out = []
    for n_data, n_model in meshes:
        mesh = make_mesh(n_data, n_model, device="cpu")
        model, plan = _sharded_model(cfg, params, mesh, torch.float32)
        opt = build_optimizer(lr=lr, warmup_updates=warmup, clip_norm=clip)
        if mesh.model_group is not None:
            opt.set_tensor_parallel(
                mesh.model_group, [k for k, d in plan.items() if d is not None])
        state = create_train_state(dict(model.named_parameters()), opt)
        step = make_mt_train_step(model.train(), opt)
        local = shard_batch_safe(
            {k: torch.tensor(v) for k, v in batch.items()}, mesh)
        state, metrics = step(state, local, torch.Generator().manual_seed(0))
        full = gather_params(model.state_dict(), mesh, plan)
        mu = gather_params(state.opt_state.mu, mesh, plan)
        out.append((float(metrics["sum_loss"]), float(metrics["ntokens"]),
                    {k: v.numpy() for k, v in full.items()},
                    {k: v.numpy() for k, v in mu.items()}))
    return out


def beam_decode(rank, cfg, params, src, mask, langs, first, tgt_langs,
                sizes, beam_kw):
    """Encode + beam_search on two ranks, under 1 x 2 (tensor parallel:
    every rank decodes every row) and under 2 x 1 (each rank decodes its
    half of the rows, the early exit joined over the data group); both
    meshes' (best, lengths), the rows gathered."""
    from imagetranslate_tpu_torch.decoding.beam import beam_search
    from imagetranslate_tpu_torch.parallel.comm import all_gather_stack

    torch.set_num_threads(1)
    out = []
    for n_data, n_model in ((1, 2), (2, 1)):
        mesh = make_mesh(n_data, n_model, device="cpu")
        model, _ = _sharded_model(cfg, params, mesh)
        rows = src.shape[0] // n_data
        sl = slice(mesh.d * rows, (mesh.d + 1) * rows)
        with torch.no_grad():
            enc = model.encode(torch.tensor(src[sl]), torch.tensor(mask[sl]),
                               torch.tensor(langs[sl]))
            best, lengths = beam_search(
                model, enc, torch.tensor(mask[sl]), torch.tensor(first[sl]),
                torch.tensor(tgt_langs[sl]), torch.tensor(sizes[sl]),
                data_group=mesh.data_group, **beam_kw)
        best = all_gather_stack(best, mesh.data_group).flatten(0, 1)
        lengths = all_gather_stack(lengths, mesh.data_group).flatten()
        out.append((best.numpy(), lengths.numpy()))
    return out
