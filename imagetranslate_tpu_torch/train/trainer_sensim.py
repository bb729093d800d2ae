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
package resumes from and scores with what the other trained. One device: a
mesh is refused (ROADMAP module 14).
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

import numpy as np
import torch

from imagetranslate_tpu_torch.data.loader import MassBatcher, MTBatcher
from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.sensim import SenSim
from imagetranslate_tpu_torch.train.checkpoint import save_checkpoint
from imagetranslate_tpu_torch.train.optimizer import (
    build_optimizer,
    set_schedule_step,
)
from imagetranslate_tpu_torch.train.step import (
    _to,
    create_train_state,
    make_sensim_train_step,
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

    def _setup(self, model, cfg: Seq2SeqConfig, params, lr: float,
               warmup: int, clip: float, mesh, seed: int, make_step):
        if mesh is not None:
            raise NotImplementedError("a mesh: multi-device training is not "
                                      "ported yet (ROADMAP module 14)")
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        self.rng = torch.Generator().manual_seed(seed)  # the dropout seeds
        self.best_loss = float("inf")
        self.optimizer = build_optimizer(lr=lr, warmup_updates=warmup,
                                         clip_norm=clip)
        self.step_fn = make_step(model, self.optimizer)
        self.set_reference_params(
            self.BRIDGE.random_params(cfg, seed) if params is None
            else params)

    def set_reference_params(self, params, step: int = 0):
        """Replace the weights from a flax-layout tree and reset the
        optimizer state to match; ``step`` re-seats the LR schedule."""
        self.model.load_state_dict(
            self.BRIDGE.state_dict_from_flax(params, self.cfg), strict=True)
        self.state = create_train_state(dict(self.model.named_parameters()),
                                        self.optimizer)
        if step:
            set_schedule_step(self.state.opt_state, step)

    def params_tree(self) -> dict:
        """The fp32 masters as the flax-layout ``{"params": ...}``."""
        return self.BRIDGE.flax_from_state_dict(self.model.state_dict(),
                                                self.cfg)

    def _save(self, path: str, step: int):
        save_checkpoint(
            path, self.cfg, self.params_tree(),
            opt_state=flax_from_opt_state(self.state.opt_state,
                                          self.optimizer, self.cfg,
                                          self.BRIDGE),
            step=step, best_metric=self.best_loss)

    def _epoch(self, step: int, saving_path: str, batches, stage, evaluate,
               max_step: int, eval_every: int, log_every: int) -> int:
        """Steps over ``batches`` (``stage`` runs in the prefetch thread),
        ``evaluate()`` every ``eval_every`` steps and after the epoch's
        ``.latest`` save."""
        from imagetranslate_tpu_torch.data.prefetch import PrefetchIterator
        from imagetranslate_tpu_torch.utils.metrics import AsyncStepMeter

        meter = AsyncStepMeter(log_every=log_every)
        prefetcher = PrefetchIterator(batches, stage, depth=3)
        try:
            for batch in prefetcher:
                self.state, m = self.step_fn(self.state, batch, self.rng)
                step += 1
                meter.update(step, m["sum_loss"], m["ntokens"])
                if evaluate is not None and step % eval_every == 0:
                    print(f"Dev Loss: {evaluate():.4f}", flush=True)
                if step >= max_step:
                    break
        finally:
            prefetcher.close()
        meter.finish(step)
        print(f"Total loss in this epoch: {meter.epoch_loss():.4f}",
              flush=True)
        self._save(saving_path + ".latest", step)
        if evaluate is not None:
            print(f"Dev Loss: {evaluate():.4f}", flush=True)
        return step


class SenSimTrainer(BridgedTrainer):
    BRIDGE = SENSIM

    def __init__(self, cfg: Seq2SeqConfig, tp, params=None, lr: float = 1e-4,
                 warmup: int = 4000, clip: float = 1.0, mesh=None,
                 seed: int = 0, device="cuda"):
        """``params``: a flax-layout ``SenSim`` tree to start from (None:
        random, from ``seed``). ``device``: where the model trains; ``cuda``
        fails without a card."""
        self.tp = tp
        model = SenSim(cfg, device=torch.device(device),
                       param_dtype=torch.float32)
        self._setup(model, cfg, params, lr, warmup, clip, mesh, seed,
                    make_sensim_train_step)

    def stage(self, b, src_neg=None, dst_neg=None) -> Dict[str,
                                                          torch.Tensor]:
        """An MTBatch (and one MassBatch of each pool) -> the step's dict on
        the device."""
        dev = self.device
        batch = mt_batch_to_device(b, dev)
        for prefix, nb in (("src_neg", src_neg), ("tgt_neg", dst_neg)):
            if nb is not None:
                batch[prefix] = _to(nb.src, dev)
                batch[f"{prefix}_mask"] = _to(nb.src_mask, dev)
                batch[f"{prefix}_langs"] = _to(nb.langs, dev)
                batch[f"{prefix}_row_mask"] = _to(nb.row_mask, dev)
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
            s = self.stage(b)
            loss = self.model(s["src"], s["src_mask"], s["src_langs"],
                              s["dst"], s["dst_mask"], s["dst_langs"],
                              row_mask=s["row_mask"])
            n = int(b.row_mask.sum())
            total += float(loss) * n
            items += n
        dev_loss = total / max(items, 1)
        if dev_loss <= self.best_loss:
            self.best_loss = dev_loss
            print(f"Saving best Loss {self.best_loss:.4f}", flush=True)
            self._save(saving_path, self.state.step)
        return dev_loss

    @torch.no_grad()
    def similarities(self, b) -> np.ndarray:
        """Per-pair cosine of an MTBatch's rows, padding rows included."""
        s = self.stage(b)
        return self.model.similarity(
            s["src"], s["src_mask"], s["src_langs"], s["dst"],
            s["dst_mask"], s["dst_langs"]).cpu().numpy()
