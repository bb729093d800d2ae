"""MLM trainer (port of imagetranslate_tpu/train/trainer_lm.py): 80/10/10
corruption, NLL on the masked positions, model selection by dev loss with the
best slot at ``model_path`` and the rolling best-train slot at ``.latest``.

The model holds fp32 master parameters and computes in ``cfg.dtype``.

Under a mesh (``parallel.mesh.ProcessMesh``, one process a rank) the model
keeps this rank's shard of the JAX TP rules (``LM.shard_``: heads, FFN and
the word table's vocab rows split, ``out_bias`` whole), each step and each
dev batch take this rank's rows, copied from the host alone (every rank
builds the same batches; the data axis must divide their rows), and the
steps hold the global batch semantics (train/step.py). Checkpoints hold the
gathered one-device state, written by rank 0; a load shards it again. Only
rank 0 logs.
"""

from __future__ import annotations

from typing import Optional

import torch

from imagetranslate_tpu_torch.data.loader import DocBlockDataset
from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.lm import LM
from imagetranslate_tpu_torch.parallel.mesh import (
    ProcessMesh,
    gather_params,
    host_rows,
    shard_params,
)
from imagetranslate_tpu_torch.text.processor import TextProcessor
from imagetranslate_tpu_torch.train import weights
from imagetranslate_tpu_torch.train.checkpoint import save_checkpoint
from imagetranslate_tpu_torch.train.optimizer import (
    build_optimizer,
    map_moments,
    set_schedule_step,
)
from imagetranslate_tpu_torch.train.step import (
    create_train_state,
    lm_batch_to_device,
    make_mlm_eval_step,
    make_mlm_train_step,
)


class LMTrainer:
    bridge = weights.LM
    mesh: Optional[ProcessMesh] = None
    chief = True    # rank 0 of the mesh, or no mesh: logs and writes
    plan = None     # under a mesh: state_dict key -> split dim or None

    def __init__(self, cfg: Seq2SeqConfig, tp: TextProcessor,
                 lr: float = 1e-4, warmup: int = 4000, clip: float = 1.0,
                 mask_prob: float = 0.15, mesh: Optional[ProcessMesh] = None,
                 seed: int = 0, device="cuda", params=None):
        """``params``: a flax-layout parameter tree to start from (None:
        random, the JAX model's initializers from ``seed``). ``device``:
        where the model trains; ``cuda`` fails without a card; under a
        ``mesh`` the mesh's device."""
        self.cfg = cfg
        self.tp = tp
        self.mesh = mesh
        self.chief = mesh is None or mesh.rank == 0
        self.device = torch.device(device) if mesh is None else mesh.device
        self.model = self.build_model(cfg)
        if mesh is not None:
            self.plan = self.shard_model(mesh)
        self.rng = torch.Generator().manual_seed(seed)  # the dropout seeds
        self.best_dev_loss = float("inf")
        self.best_train_loss = float("inf")
        self.optimizer = build_optimizer(lr=lr, warmup_updates=warmup,
                                         clip_norm=clip)
        split = [k for k, d in (self.plan or {}).items() if d is not None]
        if split:
            self.optimizer.set_tensor_parallel(mesh.model_group, split)
        kw = dict(mask_prob=mask_prob, n_specials=len(tp.special_tokens),
                  mask_id=tp.mask_token_id())
        self.step_fn = make_mlm_train_step(self.model, self.optimizer, cfg,
                                           **kw)
        self.eval_fn = make_mlm_eval_step(self.model, cfg, **kw)
        self.set_reference_params(
            self.bridge.random_params(cfg, seed) if params is None
            else params)

    def build_model(self, cfg: Seq2SeqConfig):
        return LM(cfg, device=self.device, param_dtype=torch.float32)

    def shard_model(self, mesh: ProcessMesh):
        """Keep this rank's shard of the model; the plan."""
        return self.model.shard_(mesh)

    def _cols(self, seq_len: int) -> slice:
        """The positions of a row this rank holds (all of them here)."""
        return slice(None)

    def stage(self, b) -> dict:
        """A batch dict of numpy arrays -> this rank's share of it on the
        device (copied from the host alone)."""
        rows = b["texts"].shape[0]
        if self.mesh is not None and rows % self.mesh.n_data:
            raise ValueError(f"{rows} rows a batch: the data axis "
                             f"({self.mesh.n_data}) must divide them")
        return lm_batch_to_device(b, self.device, host_rows(rows, self.mesh),
                                  self._cols(b["texts"].shape[1]))

    def train_epoch(self, step: int, saving_path: str,
                    train_data: DocBlockDataset,
                    dev_data: Optional[DocBlockDataset],
                    batch_rows: int, max_step: int,
                    eval_every: int = 500, log_every: int = 50) -> int:
        from imagetranslate_tpu_torch.data.prefetch import PrefetchIterator
        from imagetranslate_tpu_torch.utils.metrics import AsyncStepMeter

        meter = AsyncStepMeter(log_every=log_every, quiet=not self.chief)
        pad = self.tp.pad_token_id()
        # Staging batch N+1 onto the device (in the prefetch thread) overlaps
        # the step on batch N.
        prefetcher = PrefetchIterator(
            train_data.batches(batch_rows, pad_id=pad), self.stage, depth=3)
        try:
            for batch in prefetcher:
                self.state, m = self.step_fn(self.state, batch, self.rng)
                step += 1
                meter.update(step, m["sum_loss"], m["ntokens"])
                if dev_data is not None and step % eval_every == 0:
                    self.validate_and_save(saving_path, dev_data, batch_rows)
                if step >= max_step:
                    break
        finally:
            prefetcher.close()

        meter.finish(step)
        train_loss = meter.epoch_loss()
        if self.chief:
            print(f"Total loss in this epoch: {train_loss:.4f}", flush=True)
        if train_loss < self.best_train_loss:
            self.best_train_loss = train_loss
            self._save(saving_path + ".latest", step)
        if dev_data is not None:
            self.validate_and_save(saving_path, dev_data, batch_rows)
        return step

    def validate_and_save(self, saving_path: str, dev_data: DocBlockDataset,
                          batch_rows: int) -> float:
        pad = self.tp.pad_token_id()
        # A fresh generator with a fixed seed at every validation: the dev
        # masks are the same each time, so dev losses compare (and every
        # rank draws the global batch's).
        gen = torch.Generator(device=self.device).manual_seed(0)
        total = torch.zeros((), device=self.device)
        count = torch.zeros((), device=self.device)
        for b in dev_data.batches(batch_rows, pad_id=pad):
            sum_l, n = self.eval_fn(self.stage(b), gen)
            total += sum_l
            count += n
        dev_loss = float(total) / max(float(count), 1)
        if self.chief:
            print(f"Current dev loss {dev_loss:.4f}", flush=True)
        if dev_loss < self.best_dev_loss:
            self.best_dev_loss = dev_loss
            if self.chief:
                print(f"saving best dev loss {self.best_dev_loss:.4f}",
                      flush=True)
            self._save(saving_path, self.state.step)
        return dev_loss

    # ---------------- persistence ----------------

    def _full(self, sd):
        """This rank's tensors -> the one-device layout (collective over
        the model group where the plan splits any)."""
        if self.mesh is None or not self.plan:
            return sd
        return gather_params(sd, self.mesh, self.plan)

    def _local(self, sd):
        """Full tensors -> this rank's shards."""
        if self.mesh is None or not self.plan:
            return sd
        return shard_params(sd, self.mesh, self.plan)

    def params_tree(self) -> dict:
        """The fp32 master parameters as the flax-layout tree (gathered
        under a mesh: every rank calls it)."""
        return self.bridge.flax_from_state_dict(
            self._full(self.model.state_dict()), self.cfg)

    def _save(self, path: str, step: int):
        """Every rank gathers; rank 0 writes the one-device layout."""
        params = self.params_tree()
        opt_state = weights.flax_from_opt_state(
            map_moments(self.state.opt_state, self._full), self.optimizer,
            self.cfg, self.bridge)
        if self.chief:
            save_checkpoint(path, self.cfg, params, opt_state=opt_state,
                            step=step, best_metric=self.best_dev_loss)

    def set_reference_params(self, params, step: int = 0):
        """Replace the model weights from a flax-layout tree (the full
        state; sharded here under a mesh) and reset the optimizer state to
        match. ``step`` (a checkpoint's saved step) re-seats the LR schedule
        there."""
        self.model.load_state_dict(self._local(
            self.bridge.state_dict_from_flax(params, self.cfg)))
        self.state = create_train_state(dict(self.model.named_parameters()),
                                        self.optimizer)
        if step:
            set_schedule_step(self.state.opt_state, step)
