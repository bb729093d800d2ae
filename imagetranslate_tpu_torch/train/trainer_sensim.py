"""Sentence-similarity trainer (port of
imagetranslate_tpu/train/trainer_sensim.py: ``SenSimTrainer`` with the
cycled negative pools, dev-loss best-model selection, ``similarities`` and
checkpoints), and ``BridgedTrainer``, the part it shares with
``train/trainer_txt2image.py``.

- a prefetch thread stages each parallel batch (and, with the pools, the
  next batch of each ``MassBatcher``, cycled in order) onto the device while
  the previous step runs; telemetry every ``log_every`` steps through
  ``AsyncStepMeter``;
- the dev loss every ``eval_every`` steps and at the end of an epoch; a dev
  loss at or below the best so far saves the model into the model
  directory itself, and every epoch ends with a ``.latest`` checkpoint.

The model holds fp32 master parameters and computes in ``cfg.dtype``.
Checkpoints are the JAX package's layout (``weights.SENSIM``), so either
package resumes from and scores with what the other trained.

Under a mesh (``parallel.mesh.ProcessMesh``, one process a rank) the model
keeps this rank's shard of the JAX TP rules, each step copies this rank's
rows of the pairs and of each pool from the host (the pools' rows where the
data axis divides them) and holds the global batch semantics: the InfoNCE
columns are every rank's vectors, gathered over the data group. Checkpoints
hold the gathered one-device state, written by rank 0; the dev loss is
taken on every rank over all of the dev rows. Only rank 0 logs.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

import numpy as np
import torch

from imagetranslate_tpu_torch.data.loader import MassBatcher, MTBatcher
from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.sensim import SenSim
from imagetranslate_tpu_torch.parallel.mesh import (
    gather_params,
    host_rows,
    shard_params,
)
from imagetranslate_tpu_torch.train.checkpoint import save_checkpoint
from imagetranslate_tpu_torch.train.optimizer import (
    build_optimizer,
    map_moments,
    set_schedule_step,
)
from imagetranslate_tpu_torch.train.step import (
    _to,
    create_train_state,
    make_sensim_train_step,
    mark_whole,
    mt_batch_to_device,
)
from imagetranslate_tpu_torch.train.weights import (
    SENSIM,
    Bridge,
    flax_from_opt_state,
)


class BridgedTrainer:
    """A trainer of one text-encoder model (``self.model``, fp32 masters)
    whose weights cross to the JAX package through ``BRIDGE``: the weights
    in and out, checkpoints with the Adam state, and the epoch loop."""

    BRIDGE: Bridge
    mesh = None
    chief = True    # rank 0 of the mesh, or no mesh: logs and writes
    plan = None

    def _setup(self, model, cfg: Seq2SeqConfig, params, lr: float,
               warmup: int, clip: float, mesh, seed: int, make_step):
        self.cfg = cfg
        self.model = model
        self.mesh = mesh
        self.chief = mesh is None or mesh.rank == 0
        self.device = next(model.parameters()).device
        self.rng = torch.Generator().manual_seed(seed)  # the dropout seeds
        self.best_loss = float("inf")
        self.optimizer = build_optimizer(lr=lr, warmup_updates=warmup,
                                         clip_norm=clip)
        if mesh is not None:
            self.plan = model.shard_(mesh)
            split = [k for k, d in self.plan.items() if d is not None]
            if split:
                self.optimizer.set_tensor_parallel(mesh.model_group, split)
        self.step_fn = make_step(model, self.optimizer)
        self.set_reference_params(
            self.BRIDGE.random_params(cfg, seed) if params is None
            else params)

    def _full(self, sd):
        """This rank's tensors -> the one-device layout (collective over
        the model group under a mesh)."""
        return sd if self.mesh is None else gather_params(sd, self.mesh,
                                                          self.plan)

    def _local(self, sd):
        return sd if self.mesh is None else shard_params(sd, self.mesh,
                                                         self.plan)

    def set_reference_params(self, params, step: int = 0):
        """Replace the weights from a flax-layout tree (the full state;
        sharded here under a mesh) and reset the optimizer state to match;
        ``step`` re-seats the LR schedule."""
        self.model.load_state_dict(self._local(
            self.BRIDGE.state_dict_from_flax(params, self.cfg)), strict=True)
        self.state = create_train_state(dict(self.model.named_parameters()),
                                        self.optimizer)
        if step:
            set_schedule_step(self.state.opt_state, step)

    def params_tree(self) -> dict:
        """The fp32 masters as the flax-layout ``{"params": ...}``
        (gathered under a mesh: every rank calls it)."""
        return self.BRIDGE.flax_from_state_dict(
            self._full(self.model.state_dict()), self.cfg)

    def _save(self, path: str, step: int):
        """Every rank gathers; rank 0 writes the one-device layout."""
        params = self.params_tree()
        opt_state = flax_from_opt_state(
            map_moments(self.state.opt_state, self._full), self.optimizer,
            self.cfg, self.BRIDGE)
        if self.chief:
            save_checkpoint(path, self.cfg, params, opt_state=opt_state,
                            step=step, best_metric=self.best_loss)


    def _epoch(self, step: int, saving_path: str, batches, stage, evaluate,
               max_step: int, eval_every: int, log_every: int) -> int:
        """Steps over ``batches`` (``stage`` runs in the prefetch thread),
        ``evaluate()`` every ``eval_every`` steps and after the epoch's
        ``.latest`` save."""
        from imagetranslate_tpu_torch.data.prefetch import PrefetchIterator
        from imagetranslate_tpu_torch.utils.metrics import AsyncStepMeter

        meter = AsyncStepMeter(log_every=log_every, quiet=not self.chief)
        prefetcher = PrefetchIterator(batches, stage, depth=3)
        try:
            for batch in prefetcher:
                self.state, m = self.step_fn(self.state, batch, self.rng)
                step += 1
                meter.update(step, m["sum_loss"], m["ntokens"])
                if evaluate is not None and step % eval_every == 0:
                    self._log(f"Dev Loss: {evaluate():.4f}")
                if step >= max_step:
                    break
        finally:
            prefetcher.close()
        meter.finish(step)
        self._log(f"Total loss in this epoch: {meter.epoch_loss():.4f}")
        self._save(saving_path + ".latest", step)
        if evaluate is not None:
            self._log(f"Dev Loss: {evaluate():.4f}")
        return step

    def _log(self, line: str):
        if self.chief:
            print(line, flush=True)


class SenSimTrainer(BridgedTrainer):
    BRIDGE = SENSIM

    def __init__(self, cfg: Seq2SeqConfig, tp, params=None, lr: float = 1e-4,
                 warmup: int = 4000, clip: float = 1.0, mesh=None,
                 seed: int = 0, device="cuda"):
        """``params``: a flax-layout ``SenSim`` tree to start from (None:
        random, from ``seed``). ``device``: where the model trains; ``cuda``
        fails without a card; under a ``mesh`` the mesh's device."""
        self.tp = tp
        model = SenSim(cfg, device=torch.device(device) if mesh is None
                       else mesh.device, param_dtype=torch.float32)
        self._setup(model, cfg, params, lr, warmup, clip, mesh, seed,
                    make_sensim_train_step)

    def stage(self, b, src_neg=None, dst_neg=None,
              split: bool = True) -> Dict[str, torch.Tensor]:
        """An MTBatch (and one MassBatch of each pool) -> the step's dict on
        the device; under a mesh (``split``) this rank's rows of each, the
        arrays left whole marked so."""
        dev = self.device
        mesh = self.mesh if split else None
        marks = mesh is not None and mesh.n_data > 1
        rows = host_rows(b.src.shape[0], mesh)
        batch = mt_batch_to_device(b, dev, rows=rows)
        if marks:
            mark_whole(batch, list(batch), rows)
        for prefix, nb in (("src_neg", src_neg), ("tgt_neg", dst_neg)):
            if nb is not None:
                rows = host_rows(nb.src.shape[0], mesh)
                keys = (prefix, f"{prefix}_mask", f"{prefix}_langs",
                        f"{prefix}_row_mask")
                for key, arr in zip(keys, (nb.src, nb.src_mask, nb.langs,
                                           nb.row_mask)):
                    batch[key] = _to(arr, dev, rows)
                if marks:
                    mark_whole(batch, keys, rows)
        return batch

    def train_epoch(self, step: int, saving_path: str, mt_batcher: MTBatcher,
                    src_neg: Optional[MassBatcher] = None,
                    dst_neg: Optional[MassBatcher] = None,
                    dev_batcher: Optional[MTBatcher] = None,
                    max_step: int = 300_000, eval_every: int = 5000,
                    log_every: int = 50, epoch_seed: int = 0) -> int:
        """One pass over ``mt_batcher`` (shuffled by ``epoch_seed``); with
        the pools each step also takes the next batch of each, cycled in
        order."""
        src_it = itertools.cycle(src_neg.batches) if src_neg else None
        dst_it = itertools.cycle(dst_neg.batches) if dst_neg else None

        def stage(b):
            if src_it is None:
                return self.stage(b)
            return self.stage(b, next(src_it), next(dst_it))

        evaluate = (None if dev_batcher is None
                    else lambda: self.eval(dev_batcher, saving_path))
        return self._epoch(step, saving_path, mt_batcher.shuffled(epoch_seed),
                           stage, evaluate, max_step, eval_every, log_every)

    @torch.no_grad()
    def eval(self, dev_batcher: MTBatcher, saving_path: str) -> float:
        """The dev InfoNCE loss (in-batch negatives) averaged over the real
        rows; at or below the best so far, the model is saved into
        ``saving_path``."""
        total, items = 0.0, 0
        for b in dev_batcher:
            s = self.stage(b, split=False)
            loss = self.model(s["src"], s["src_mask"], s["src_langs"],
                              s["dst"], s["dst_mask"], s["dst_langs"],
                              row_mask=s["row_mask"])
            n = int(b.row_mask.sum())
            total += float(loss) * n
            items += n
        dev_loss = total / max(items, 1)
        if dev_loss <= self.best_loss:
            self.best_loss = dev_loss
            self._log(f"Saving best Loss {self.best_loss:.4f}")
            self._save(saving_path, self.state.step)
        return dev_loss

    @torch.no_grad()
    def similarities(self, b) -> np.ndarray:
        """Per-pair cosine of an MTBatch's rows, padding rows included."""
        s = self.stage(b, split=False)
        return self.model.similarity(
            s["src"], s["src_mask"], s["src_langs"], s["dst"],
            s["dst_mask"], s["dst_langs"]).cpu().numpy()
