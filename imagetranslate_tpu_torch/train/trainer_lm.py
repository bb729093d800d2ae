"""MLM trainer (port of imagetranslate_tpu/train/trainer_lm.py): 80/10/10
corruption, NLL on the masked positions, model selection by dev loss with the
best slot at ``model_path`` and the rolling best-train slot at ``.latest``.

The model holds fp32 master parameters and computes in ``cfg.dtype``. One
device: a mesh is refused (ROADMAP module 14b).
"""

from __future__ import annotations

from typing import Optional

import torch

from imagetranslate_tpu_torch.data.loader import DocBlockDataset
from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.lm import LM
from imagetranslate_tpu_torch.text.processor import TextProcessor
from imagetranslate_tpu_torch.train import weights
from imagetranslate_tpu_torch.train.checkpoint import save_checkpoint
from imagetranslate_tpu_torch.train.optimizer import (
    build_optimizer,
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

    def __init__(self, cfg: Seq2SeqConfig, tp: TextProcessor,
                 lr: float = 1e-4, warmup: int = 4000, clip: float = 1.0,
                 mask_prob: float = 0.15, mesh=None, seed: int = 0,
                 device="cuda", params=None):
        """``params``: a flax-layout parameter tree to start from (None:
        random, the JAX model's initializers from ``seed``). ``device``:
        where the model trains; ``cuda`` fails without a card."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh: multi-device training is not ported yet (ROADMAP "
                "module 14b)")
        self.cfg = cfg
        self.tp = tp
        self.device = torch.device(device)
        self.model = self.build_model(cfg)
        self.rng = torch.Generator().manual_seed(seed)  # the dropout seeds
        self.best_dev_loss = float("inf")
        self.best_train_loss = float("inf")
        self.optimizer = build_optimizer(lr=lr, warmup_updates=warmup,
                                         clip_norm=clip)
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

    def train_epoch(self, step: int, saving_path: str,
                    train_data: DocBlockDataset,
                    dev_data: Optional[DocBlockDataset],
                    batch_rows: int, max_step: int,
                    eval_every: int = 500, log_every: int = 50) -> int:
        from imagetranslate_tpu_torch.data.prefetch import PrefetchIterator
        from imagetranslate_tpu_torch.utils.metrics import AsyncStepMeter

        meter = AsyncStepMeter(log_every=log_every)
        pad = self.tp.pad_token_id()
        # Staging batch N+1 onto the device (in the prefetch thread) overlaps
        # the step on batch N.
        prefetcher = PrefetchIterator(
            train_data.batches(batch_rows, pad_id=pad),
            lambda b: lm_batch_to_device(b, self.device), depth=3)
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
        # masks are the same each time, so dev losses compare.
        gen = torch.Generator(device=self.device).manual_seed(0)
        total = torch.zeros((), device=self.device)
        count = torch.zeros((), device=self.device)
        for b in dev_data.batches(batch_rows, pad_id=pad):
            sum_l, n = self.eval_fn(lm_batch_to_device(b, self.device), gen)
            total += sum_l
            count += n
        dev_loss = float(total) / max(float(count), 1)
        print(f"Current dev loss {dev_loss:.4f}", flush=True)
        if dev_loss < self.best_dev_loss:
            self.best_dev_loss = dev_loss
            print(f"saving best dev loss {self.best_dev_loss:.4f}",
                  flush=True)
            self._save(saving_path, self.state.step)
        return dev_loss

    # ---------------- persistence ----------------

    def params_tree(self) -> dict:
        """The fp32 master parameters as the flax-layout tree."""
        return self.bridge.flax_from_state_dict(self.model.state_dict(),
                                                self.cfg)

    def _save(self, path: str, step: int):
        save_checkpoint(
            path, self.cfg, self.params_tree(),
            opt_state=weights.flax_from_opt_state(
                self.state.opt_state, self.optimizer, self.cfg, self.bridge),
            step=step, best_metric=self.best_dev_loss)

    def set_reference_params(self, params, step: int = 0):
        """Replace the model weights from a flax-layout tree and reset the
        optimizer state to match. ``step`` (a checkpoint's saved step)
        re-seats the LR schedule there."""
        self.model.load_state_dict(
            self.bridge.state_dict_from_flax(params, self.cfg))
        self.state = create_train_state(dict(self.model.named_parameters()),
                                        self.optimizer)
        if step:
            set_schedule_step(self.state.opt_state, step)
