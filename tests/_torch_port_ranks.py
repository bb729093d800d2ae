"""Rank functions for tests/test_torch_port_parallel.py,
tests/test_torch_port_k2b.py, tests/test_torch_port_zero.py,
tests/test_torch_port_pipeline.py, tests/test_torch_port_expert_parallel.py,
tests/test_torch_port_mesh_lm.py and tests/test_torch_port_mesh_image.py:
each runs in a process of its own, spawned by
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
    ProcessMesh,
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
    """One MT step from ``params`` under each (n_data, n_model) or
    (n_data, n_model, min_size) of ``meshes``, the latter under ZeRO-1 with
    the layout's ``min_size`` lowered (the tiny model's tensors are all
    below JAX's 4096); per mesh the global loss sum and count, the gathered
    updated parameters and Adam first moments, and how many tensors this
    rank holds a ZeRO slice of."""
    from imagetranslate_tpu_torch.parallel.zero import ZeroLayout
    from imagetranslate_tpu_torch.train.optimizer import build_optimizer
    from imagetranslate_tpu_torch.train.step import (
        create_train_state,
        make_mt_train_step,
    )

    torch.set_num_threads(1)
    out = []
    for n_data, n_model, *min_size in meshes:
        mesh = make_mesh(n_data, n_model, device="cpu")
        model, plan = _sharded_model(cfg, params, mesh, torch.float32)
        opt = build_optimizer(lr=lr, warmup_updates=warmup, clip_norm=clip)
        if mesh.model_group is not None:
            opt.set_tensor_parallel(
                mesh.model_group, [k for k, d in plan.items() if d is not None])
        shapes = {k: p.shape for k, p in model.named_parameters()}
        zero = None
        if min_size:
            zero = ZeroLayout(shapes, mesh, cfg, plan,
                              min_size=min_size[0])
            opt.set_zero(zero)
        state = create_train_state(dict(model.named_parameters()), opt)
        step = make_mt_train_step(model.train(), opt)
        local = shard_batch_safe(
            {k: torch.tensor(v) for k, v in batch.items()}, mesh)
        state, metrics = step(state, local, torch.Generator().manual_seed(0))
        full = gather_params(model.state_dict(), mesh, plan)
        mu = state.opt_state.mu
        if zero is not None:
            mu = zero.full_dict(mu, shapes)
        mu = gather_params(mu, mesh, plan)
        out.append((float(metrics["sum_loss"]), float(metrics["ntokens"]),
                    _np(full), _np(mu),
                    0 if zero is None else sum(map(zero.split, shapes))))
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


class Tok:
    """What MTTrainer reads of a TextProcessor outside its decodes."""
    special_tokens = ["<pad>", "<unk>", "<s>", "<mask>", "</s>"]

    def pad_token_id(self):
        return 0

    def mask_token_id(self):
        return 3

    def sep_token_id(self):
        return 4


def _np(sd):
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _trainer_steps(trainer, batches, mesh):
    """Each (kind, batch) of ``batches`` through the trainer's step on this
    rank's rows, step i's generator seeded with i (so that a MASS step
    draws the one-process step's spans: the steps draw different numbers
    of dropout seeds); the global losses."""
    losses = []
    for i, (kind, batch) in enumerate(batches):
        local = shard_batch_safe({k: torch.tensor(v) for k, v in
                                  batch.items()}, mesh)
        fn = trainer.mass_step if kind == "mass" else trainer.mt_step
        trainer.state, m = fn(trainer.state, local,
                              torch.Generator().manual_seed(i))
        losses.append(float(m["sum_loss"]) / float(m["ntokens"]))
    return losses


def _state_bytes(opt_state) -> int:
    """The bytes of the optimizer state's tensors on this rank."""
    from imagetranslate_tpu_torch.train.optimizer import map_moments

    total = []
    map_moments(opt_state, lambda d: total.append(
        sum(t.numel() * t.element_size() for t in d.values())) or d)
    return sum(total)


def zero_steps(rank, cfg, params, batches, cases, opt_kw, out_dir):
    """Per (n_data, n_model, zero, accum) of ``cases``: an MTTrainer over
    that mesh takes ``batches``, then saves its checkpoint (rank 0 writes
    ``out_dir/case{i}``). Returns per case the losses, this rank's
    optimizer-state bytes, and the ZeRO layout's flax dims (None without
    ZeRO), and whether a trainer that loads the checkpoint's optimizer
    state holds the same moments (slices under ZeRO)."""
    from imagetranslate_tpu_torch.train.checkpoint import load_checkpoint
    from imagetranslate_tpu_torch.train.optimizer import map_moments
    from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer

    torch.set_num_threads(1)
    out = []
    for i, (n_data, n_model, zero, accum) in enumerate(cases):
        mesh = make_mesh(n_data, n_model, device="cpu")
        trainer = MTTrainer(cfg, Tok(), params=params, mesh=mesh, zero=zero,
                            accum=accum, device="cpu", **opt_kw)
        losses = _trainer_steps(trainer, batches, mesh)
        path = f"{out_dir}/case{i}"
        trainer._save(path, trainer.state.step)
        torch.distributed.barrier()
        # A resumed run's moments: the saved one-device state, sliced again.
        again = MTTrainer(cfg, Tok(), params=params, mesh=mesh, zero=zero,
                          accum=accum, device="cpu", **opt_kw)
        again.load_opt_state(load_checkpoint(path, with_opt_state=True)[1])
        same = []
        map_moments(trainer.state.opt_state, lambda d: same.append(d) or d)
        map_moments(again.state.opt_state, lambda d: same.append(d) or d)
        half = len(same) // 2
        resumed = all(torch.equal(a[k], b[k]) for a, b in
                      zip(same[:half], same[half:]) for k in a)
        out.append((losses, _state_bytes(trainer.state.opt_state),
                    None if trainer.zero is None
                    else dict(trainer.zero.flax_dims), resumed))
    return out


def _meshes(rank):
    """(mesh of n_data x n_model): the world's mesh, or for a mesh of two
    ranks in a larger world one over ranks 0 and 1 (JAX's make_mesh over the
    first D x M devices; None on the other ranks). The pair's group is made
    here, by every rank."""
    world = torch.distributed.get_world_size()
    pair = torch.distributed.new_group([0, 1]) if world > 2 else None

    def mesh(n_data, n_model):
        if n_data * n_model == world:
            return make_mesh(n_data, n_model, device="cpu")
        if rank >= 2:
            return None
        d, m = (rank, 0) if n_model == 1 else (0, rank)
        return ProcessMesh(n_data, n_model, d, m,
                           pair if n_model > 1 else None,
                           pair if n_data > 1 else None)
    return mesh


def pipeline_steps(rank, cases, opt_kw):
    """Per (cfg, params, n_data, n_model, microbatches, zero, batches) of
    ``cases``: a pipelined MTTrainer takes the (kind, batch) ``batches``
    (a case of two ranks in a world of four on ranks 0 and 1). Returns per
    case the losses, this rank's parameter names, and (rank 0) the merged
    one-device parameters; None where the rank sat out."""
    from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer

    torch.set_num_threads(1)
    meshes = _meshes(rank)
    out = []
    for cfg, params, n_data, n_model, micro, zero, batches in cases:
        mesh = meshes(n_data, n_model)
        if mesh is None:
            out.append(None)
            continue
        trainer = MTTrainer(cfg, Tok(), params=params, mesh=mesh,
                            pp_microbatches=micro, zero=zero, device="cpu",
                            **opt_kw)
        losses = _trainer_steps(trainer, batches, mesh)
        merged = trainer._full(None)
        out.append((losses, sorted(trainer.state.params),
                    _np(merged) if rank == 0 else None))
    return out


def expert_parallel(rank, cfg, params, batches, meshes, opt_kw,
                    decode=None):
    """Per (n_data, n_model) of ``meshes`` (one of two ranks in a world of
    four on ranks 0 and 1): an MoE MTTrainer takes ``batches``. Returns per
    mesh the losses, this rank's router weights with their Adam moments
    (each rank holds the whole router), the plan and (rank 0) the gathered
    parameters, or None where the rank sat out; with ``decode`` = (src,
    mask, langs, first, tgt_langs, sizes, beam_kw), also the beam decode of
    ``params`` under 1 x 2 (experts split) on ranks 0 and 1: (best,
    lengths)."""
    from imagetranslate_tpu_torch.decoding.beam import beam_search
    from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer

    torch.set_num_threads(1)
    make = _meshes(rank)
    out = []
    for n_data, n_model in meshes:
        mesh = make(n_data, n_model)
        if mesh is None:
            out.append(None)
            continue
        trainer = MTTrainer(cfg, Tok(), params=params, mesh=mesh,
                            device="cpu", **opt_kw)
        losses = _trainer_steps(trainer, batches, mesh)
        opt = trainer.state.opt_state
        routers = {k: (v.detach().numpy(), opt.mu[k].numpy(),
                       opt.nu[k].numpy())
                   for k, v in trainer.state.params.items()
                   if k.endswith("moe.router.weight")}
        full = trainer._full(trainer.model.state_dict())
        out.append((losses, routers, trainer.plan,
                    _np(full) if rank == 0 else None))
    if decode is None:
        return out, None
    mesh = make(1, 2)
    if mesh is None:
        return out, None
    src, mask, langs, first, tgt_langs, sizes, beam_kw = decode
    model, _ = _sharded_model(cfg, params, mesh)
    with torch.no_grad():
        enc = model.encode(torch.tensor(src), torch.tensor(mask),
                           torch.tensor(langs))
        best, lengths = beam_search(
            model, enc, torch.tensor(mask), torch.tensor(first),
            torch.tensor(tgt_langs), torch.tensor(sizes), **beam_kw)
    return out, (best.numpy(), lengths.numpy())


class SGD:
    """params -= lr * grads (``optax.sgd``): a step's parameter change is its
    gradient, which the mesh tests compare."""
    chain = ()

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return None

    @torch.no_grad()
    def update(self, grads, state, params):
        torch._foreach_add_(list(params.values()), grads, alpha=-self.lr)


def mlm_mesh(rank, cases, opt_kw):
    """Per (kind, cfg, params, batch, (n_data, n_model), draws) of
    ``cases`` ("lm": ``LMTrainer``, "longdoc": ``LongDocTrainer``; a mesh of
    two ranks in a world of four on ranks 0 and 1): the trainer stages this
    rank's share of the global numpy ``batch`` and takes one MLM step with
    the global ``draws`` (numpy sel, u, rand_tok; None: drawn). Returns per
    case the global (sum_loss, ntokens), this rank's (d, m), its share of
    the deterministic forward's logits (long-doc only) and (rank 0) the
    gathered parameters and Adam first moments; None where the rank sat
    out."""
    from imagetranslate_tpu_torch.ops.masking import MLMDraws
    from imagetranslate_tpu_torch.train.trainer_lm import LMTrainer
    from imagetranslate_tpu_torch.train.trainer_longdoc import LongDocTrainer

    torch.set_num_threads(1)
    make = _meshes(rank)
    out = []
    for kind, cfg, params, batch, (n_data, n_model), draws in cases:
        mesh = make(n_data, n_model)
        if mesh is None:
            out.append(None)
            continue
        cls = LongDocTrainer if kind == "longdoc" else LMTrainer
        trainer = cls(cfg, Tok(), params=params, mesh=mesh, device="cpu",
                      **opt_kw)
        staged = trainer.stage(batch)
        logits = None
        if kind == "longdoc":
            with torch.no_grad():
                logits = trainer.model(staged["texts"], staged["pad_mask"],
                                       staged["langs"]).numpy()
        if draws is not None:
            draws = MLMDraws(*(torch.tensor(a) for a in draws))
        trainer.state, m = trainer.step_fn(
            trainer.state, staged, torch.Generator().manual_seed(0),
            draws=draws)
        full = trainer._full(trainer.model.state_dict())
        mu = trainer._full(trainer.state.opt_state.mu)
        out.append((float(m["sum_loss"]), float(m["ntokens"]),
                    (mesh.d, mesh.m), logits,
                    _np(full) if rank == 0 else None,
                    _np(mu) if rank == 0 else None))
    return out


def _caption_model(cfg, variables, mesh):
    from imagetranslate_tpu_torch.models.captioning import ImageSeq2Seq
    from imagetranslate_tpu_torch.train.weights import CAPTION

    model = ImageSeq2Seq(cfg, param_dtype=torch.float32)
    plan = model.shard_(mesh)
    model.load_state_dict(shard_params(
        CAPTION.state_dict_from_flax(variables, cfg), mesh, plan))
    return model, plan


def image_mesh(rank, cases, lr):
    """Per (kind, cfg, variables, batch, (n_data, n_model)) of ``cases`` (a
    mesh of two ranks in a world of four on ranks 0 and 1), from the
    flax-layout ``variables`` and the global numpy ``batch``:

    - "bn": the ResNet grid in training mode of this rank's rows, and the
      running statistics after it;
    - "caption", "contrastive": one ``make_caption_train_step`` /
      ``make_contrastive_step`` step under SGD(``lr``);
    - "sensim", "c2i": one ``make_sensim_train_step`` /
      ``make_caption2image_train_step`` step under SGD(``lr``) (``variables``
      the model's flax tree).

    Returns per case the global (sum_loss, ntokens) (None for "bn"), this
    rank's d, its share of the grid ("bn") and (rank 0) the gathered state
    dict after the step; None where the rank sat out."""
    from imagetranslate_tpu_torch.models.caption2image import Caption2Image
    from imagetranslate_tpu_torch.models.sensim import SenSim
    from imagetranslate_tpu_torch.train import step as pstep
    from imagetranslate_tpu_torch.train.weights import CAPTION2IMAGE, SENSIM

    torch.set_num_threads(1)
    make = _meshes(rank)
    out = []
    for kind, cfg, variables, batch, (n_data, n_model) in cases:
        mesh = make(n_data, n_model)
        if mesh is None:
            out.append(None)
            continue
        local = shard_batch_safe({k: torch.tensor(v) for k, v in
                                  batch.items()}, mesh)
        grid = metrics = None
        if kind in ("sensim", "c2i"):
            cls, bridge = ((SenSim, SENSIM) if kind == "sensim"
                           else (Caption2Image, CAPTION2IMAGE))
            model = cls(cfg, param_dtype=torch.float32)
            plan = model.shard_(mesh)
            model.load_state_dict(shard_params(
                bridge.state_dict_from_flax(variables, cfg), mesh, plan))
            state = pstep.create_train_state(dict(model.named_parameters()),
                                             SGD(lr))
        else:
            model, plan = _caption_model(cfg, variables, mesh)
            state = pstep.create_caption_train_state(model, SGD(lr))
        if kind == "bn":
            with torch.no_grad():
                grid = model.encode_images(local["images"], train=True)
            grid = grid.numpy()
        else:
            make_step = {"caption": pstep.make_caption_train_step,
                         "contrastive": pstep.make_contrastive_step,
                         "sensim": pstep.make_sensim_train_step,
                         "c2i": pstep.make_caption2image_train_step}[kind]
            step = make_step(model.train(), SGD(lr))
            state, m = step(state, local, torch.Generator().manual_seed(0))
            metrics = (float(m["sum_loss"]), float(m["ntokens"]))
        full = gather_params(model.state_dict(), mesh, plan)
        out.append((metrics, mesh.d, grid,
                    _np(full) if rank == 0 else None))
    return out


def image_mt_zero(rank, cfg, variables, batches, opt_kw):
    """An ``ImageMTTrainer`` over the 2 x 1 mesh of ranks 0 and 1, with and
    without ZeRO-1 (its layout's ``min_size`` lowered to 512, so that the
    tiny model's tensors split), takes the (kind, global numpy batch) of
    ``batches``: "mt", "mass" (text MASS), "mm" (multimodal MASS) or
    "contrastive". Returns per arm the losses, how many tensors this rank
    holds a ZeRO slice of and (rank 0) the gathered parameters and Adam
    first moments; None on ranks 2 and 3."""
    from imagetranslate_tpu_torch.train.trainer_image_mt import (
        ImageMTTrainer,
    )

    torch.set_num_threads(1)
    mesh = _meshes(rank)(2, 1)
    if mesh is None:
        return None
    out = []
    for zero in (False, True):
        trainer = ImageMTTrainer(cfg, Tok(), variables=variables, mesh=mesh,
                                 device="cpu", **opt_kw)
        if zero:
            from imagetranslate_tpu_torch.parallel.zero import ZeroLayout

            trainer.zero = ZeroLayout(
                {k: p.shape for k, p in trainer.model.named_parameters()},
                mesh, cfg, trainer.plan, min_size=512)
            trainer.optimizer.set_zero(trainer.zero)
            trainer.set_reference_variables(variables)
        steps = {"mt": trainer.mt_step, "mass": trainer.mass_step,
                 "mm": trainer.mm_mass_step,
                 "contrastive": trainer.contrastive_step}
        losses = []
        for i, (kind, batch) in enumerate(batches):
            local = shard_batch_safe({k: torch.tensor(v) if isinstance(
                v, np.ndarray) else v for k, v in batch.items()}, mesh)
            trainer.state, m = steps[kind](trainer.state, local,
                                           torch.Generator().manual_seed(i))
            losses.append(float(m["sum_loss"]) / float(m["ntokens"]))
        shapes = {k: p.shape for k, p in trainer.state.params.items()}
        full = trainer._full(trainer.model.state_dict())
        mu = trainer._full_moments(trainer.state.opt_state.mu)
        out.append((losses, 0 if trainer.zero is None
                    else sum(map(trainer.zero.split, shapes)),
                    _np(full) if rank == 0 else None,
                    _np(mu) if rank == 0 else None))
    return out


def torchrun(n, module, *args, timeout=600):
    """``python -m torch.distributed.run --standalone --nproc-per-node n -m
    module args`` with this checkout on the path and one thread a rank;
    asserts it succeeds, returns its standard output."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "-m", module, *args],
        env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout
