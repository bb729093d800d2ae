"""Supervised MT trainer (port of imagetranslate_tpu/train/trainer_mt.py:
``MTTrainer`` with the ``mt`` stream, dev BLEU and two-slot checkpoints).

- one batch from the MT stream per step, batches shuffled per epoch, staged
  onto the device by a prefetch thread while the previous step runs;
- telemetry every ``log_every`` steps through ``AsyncStepMeter`` (one host
  sync per window), dev BLEU every ``eval_every``, a rolling ``.latest``
  checkpoint every ``save_every`` and at epoch end;
- dev BLEU by beam decode + sacrebleu(lowercase, tokenize="intl"), with
  ``bleu.output`` / ``bleu.best.output`` transcripts and a best-slot
  checkpoint.

The model holds fp32 master parameters and computes in ``cfg.dtype``. One
device: a mesh, pipeline microbatches and ZeRO are refused (ROADMAP module
14). The MASS stream, back-translation and the image stream are not ported
yet (ROADMAP modules 8 and 9).
"""

from __future__ import annotations

import os
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from imagetranslate_tpu_torch.data.loader import MTBatcher
from imagetranslate_tpu_torch.decoding.beam import (
    beam_search,
    max_len_for,
    trim_outputs,
)
from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
from imagetranslate_tpu_torch.text.processor import TextProcessor
from imagetranslate_tpu_torch.train.checkpoint import save_checkpoint
from imagetranslate_tpu_torch.train.optimizer import (
    build_optimizer,
    reset_schedule,
    set_schedule_step,
)
from imagetranslate_tpu_torch.train.step import (
    create_train_state,
    make_mt_train_step,
    mt_batch_to_device,
    packed_mt_batch_to_device,
    wrap_accum,
)
from imagetranslate_tpu_torch.train.weights import (
    flax_from_opt_state,
    flax_from_state_dict,
    random_params,
    state_dict_from_flax,
)


class MTTrainer:
    def __init__(self, cfg: Seq2SeqConfig, tp: TextProcessor,
                 params=None, lr: float = 1e-4, warmup: int = 4000,
                 clip: float = 1.0, accum: int = 1, mask_prob: float = 0.5,
                 beam_width: int = 4, bt_beam_width: int = 1,
                 max_len_a: float = 1.1, max_len_b: int = 5,
                 len_penalty_ratio: float = 0.8, label_smoothing: float = 0.1,
                 mesh=None, seed: int = 0, pp_microbatches: int = 0,
                 zero: bool = False, device="cuda"):
        """``params``: a flax-layout parameter tree to start from (None:
        random, the JAX model's initializers from ``seed``). ``device``: where
        the model trains; ``cuda`` fails without a card. ``mask_prob`` and
        ``bt_beam_width`` belong to the MASS and back-translation phases and
        are accepted for the JAX trainer's signature only."""
        if mesh is not None or pp_microbatches or zero:
            raise NotImplementedError(
                "mesh, pp_microbatches and zero: multi-device training is "
                "not ported yet (ROADMAP module 14)")
        self.cfg = cfg
        self.tp = tp
        self.device = torch.device(device)
        self.model = Seq2Seq(cfg, device=self.device,
                             param_dtype=torch.float32)
        self.rng = torch.Generator().manual_seed(seed)  # the dropout seeds
        self.beam_width = beam_width
        self.max_len_a = max_len_a
        self.max_len_b = max_len_b
        self.len_penalty_ratio = len_penalty_ratio
        self.best_bleu = -1.0
        self.reference: List[str] = []
        self.optimizer = wrap_accum(
            build_optimizer(lr=lr, warmup_updates=warmup, clip_norm=clip),
            accum)
        self.mt_step = make_mt_train_step(self.model, self.optimizer,
                                          label_smoothing=label_smoothing)
        self.set_reference_params(
            random_params(cfg, seed) if params is None else params)

    # ---------------- decoding helpers ----------------

    @torch.no_grad()
    def _decode_batch(self, src, src_mask, src_langs, first_tokens, tgt_langs,
                      src_sizes, beam_width: int,
                      max_len: Optional[int] = None):
        """Rows pad to the next power of two (>= 8), as the JAX trainer pads
        them: padded rows carry src_size 0 and freeze within a few steps, and
        keeping them keeps the loop's early exit the same."""
        n = src.shape[0]
        rows = max(8, 1 << (int(n) - 1).bit_length())

        def dev(a):
            a = np.asarray(a)
            if a.shape[0] != rows:
                a = np.pad(a, [(0, rows - a.shape[0])]
                           + [(0, 0)] * (a.ndim - 1))
            return torch.as_tensor(a).to(self.device)

        mask = dev(src_mask)
        enc = self.model.encode(dev(src), mask, dev(src_langs))
        L = max_len or max_len_for(src.shape[1], self.max_len_a,
                                   self.max_len_b,
                                   self.cfg.max_position_embeddings)
        L = min(-(-L // 16) * 16, self.cfg.max_position_embeddings)
        best, lengths = beam_search(
            self.model, enc, mask, dev(first_tokens), dev(tgt_langs),
            dev(src_sizes), beam_width=beam_width, max_len=L,
            max_len_a=self.max_len_a, max_len_b=self.max_len_b,
            len_penalty_ratio=self.len_penalty_ratio,
            pad_id=self.tp.pad_token_id(), eos_id=self.tp.sep_token_id())
        return best[:n], lengths[:n]

    # ---------------- train loops ----------------

    def train_epoch(self, step: int, saving_path: str,
                    mt_batcher: Optional[MTBatcher] = None,
                    mass_batcher=None,
                    dev_batcher: Optional[MTBatcher] = None,
                    img_batcher=None, image_root: str = "",
                    max_step: int = 300_000, fine_tune: bool = False,
                    lang_directions: Optional[Dict[int, int]] = None,
                    eval_every: int = 5000, save_every: int = 10_000,
                    log_every: int = 50, epoch_seed: int = 0) -> int:
        from imagetranslate_tpu_torch.data.prefetch import PrefetchIterator
        from imagetranslate_tpu_torch.utils.metrics import AsyncStepMeter

        if mass_batcher is not None or fine_tune or lang_directions:
            raise NotImplementedError(
                "the MASS stream and the back-translation phase are not "
                "ported yet (ROADMAP module 8)")
        if img_batcher is not None:
            raise NotImplementedError(
                "the image stream is not ported yet (ROADMAP module 9)")
        if mt_batcher is None:
            return step

        def stage(b):
            # Runs in the prefetch thread: staging batch N+1 onto the device
            # overlaps the step on batch N.
            to_dev = (packed_mt_batch_to_device if hasattr(b, "src_seg")
                      else mt_batch_to_device)
            return to_dev(b, self.device)

        meter = AsyncStepMeter(log_every=log_every)
        prefetcher = PrefetchIterator(mt_batcher.shuffled(epoch_seed), stage,
                                      depth=3)
        try:
            for staged in prefetcher:
                self.state, m = self.mt_step(self.state, staged, self.rng)
                step += 1
                # Device scalars: the meter syncs once per log window.
                meter.update(step, m["sum_loss"], m["ntokens"])
                if dev_batcher is not None and step % eval_every == 0:
                    self._try_eval(dev_batcher, saving_path)
                if step % save_every == 0:
                    self._save(saving_path + ".latest", step)
                if step >= max_step:
                    break
        finally:
            prefetcher.close()

        meter.finish(step)
        print(f"Total loss in this epoch: {meter.epoch_loss():.4f}",
              flush=True)
        self._save(saving_path + ".latest", step)
        if dev_batcher is not None:
            self._try_eval(dev_batcher, saving_path)
        return step

    def _try_eval(self, dev_batcher, saving_path):
        """Training goes on if an eval decode fails, with the cause
        printed."""
        try:
            bleu = self.eval_bleu(dev_batcher, saving_path)
            print(f"BLEU: {bleu:.2f}", flush=True)
        except Exception:
            traceback.print_exc()

    def _img_step(self, b, image_root: str, rng, images=None):
        raise NotImplementedError(
            "the image stream is not ported yet (ROADMAP module 9)")

    def _bt_step(self, b, lang_directions: Dict[int, int], rng):
        raise NotImplementedError(
            "back-translation is not ported yet (ROADMAP module 8)")

    # ---------------- evaluation ----------------

    def _strip(self, ids) -> List[int]:
        """A padded row without its pads, its leading language token and its
        closing separator."""
        ids = [t for t in ids.tolist() if t != self.tp.pad_token_id()][1:]
        if ids and ids[-1] == self.tp.sep_token_id():
            ids = ids[:-1]
        return ids

    def eval_bleu(self, dev_batcher: MTBatcher, saving_path: str) -> float:
        import sacrebleu

        if not self.reference:
            self._build_reference(dev_batcher)
        mt_output: List[str] = []
        src_text: List[str] = []
        for b in dev_batcher:
            n_real = int(b.row_mask.sum())
            best, lengths = self._decode_batch(
                b.src, b.src_mask, b.src_langs, b.dst[:, 0], b.dst_langs,
                b.src_sizes, beam_width=self.beam_width)
            outs = trim_outputs(best, lengths, remove_first_token=True)
            for i in range(n_real):
                mt_output.append(self.tp.decode(outs[i]))
                src_text.append(self.tp.decode(self._strip(b.src[i])))

        bleu = sacrebleu.corpus_bleu(mt_output,
                                     [self.reference[:len(mt_output)]],
                                     lowercase=True, tokenize="intl")
        os.makedirs(saving_path, exist_ok=True)
        transcript = "\n".join(
            s + "\n" + o + "\n" + r + "\n\n***************\n"
            for s, o, r in zip(src_text, mt_output,
                               self.reference[:len(mt_output)]))
        with open(os.path.join(saving_path, "bleu.output"), "w") as w:
            w.write(transcript)
        if bleu.score > self.best_bleu:
            self.best_bleu = bleu.score
            print(f"Saving best BLEU {self.best_bleu:.2f}", flush=True)
            with open(os.path.join(saving_path, "bleu.best.output"),
                      "w") as w:
                w.write(transcript)
            self._save(saving_path, step=self.state.step)
        return bleu.score

    def _build_reference(self, dev_batcher: MTBatcher):
        self.reference = []
        for b in dev_batcher:
            for i in range(int(b.row_mask.sum())):
                self.reference.append(self.tp.decode(self._strip(b.dst[i])))

    # ---------------- persistence / phases ----------------

    def params_tree(self) -> dict:
        """The fp32 master parameters as the flax-layout tree."""
        return flax_from_state_dict(self.model.state_dict(), self.cfg)

    def _save(self, path: str, step: int):
        save_checkpoint(
            path, self.cfg, self.params_tree(),
            opt_state=flax_from_opt_state(self.state.opt_state,
                                          self.optimizer, self.cfg),
            step=step, best_metric=self.best_bleu)

    def set_reference_params(self, params, step: int = 0):
        """Replace the model weights from a flax-layout tree and reset the
        optimizer state to match. ``step`` (a checkpoint's saved step)
        re-seats the LR schedule there."""
        self.model.load_state_dict(state_dict_from_flax(params, self.cfg))
        self.state = create_train_state(dict(self.model.named_parameters()),
                                        self.optimizer)
        if step:
            set_schedule_step(self.state.opt_state, step)

    def reset_for_finetune(self):
        """Phase 2 entry: restart the LR schedule, keep the moments."""
        reset_schedule(self.state.opt_state)

    @staticmethod
    def lang_directions(bt_langs: List[str], tp: TextProcessor):
        raise NotImplementedError(
            "back-translation is not ported yet (ROADMAP module 8)")
