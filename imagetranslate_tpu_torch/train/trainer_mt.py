"""MT / MASS / back-translation trainer (port of
imagetranslate_tpu/train/trainer_mt.py: ``MTTrainer`` with the ``mass`` and
``mt`` streams, the back-translation fine-tune phase, dev BLEU and two-slot
checkpoints).

- each tick takes one batch from every stream in the order img, mass, mt
  (the epoch ends at the shortest stream), batches shuffled per epoch and
  staged onto the device by a prefetch thread while the previous step runs;
  the img stream (image-caption batches) trains through
  ``ImageMTTrainer`` (train/trainer_image_mt.py);
- in the fine-tune phase a batch of the mass stream is back-translated: a
  decode in the other language with frozen weights, then an MT step on
  translation -> original;
- telemetry every ``log_every`` steps through ``AsyncStepMeter`` (one host
  sync per window), dev BLEU every ``eval_every``, a rolling ``.latest``
  checkpoint every ``save_every`` and at epoch end;
- dev BLEU by beam decode + sacrebleu(lowercase, tokenize="intl"), with
  ``bleu.output`` / ``bleu.best.output`` transcripts and a best-slot
  checkpoint.

The model holds fp32 master parameters and computes in ``cfg.dtype``. One
device: a mesh, pipeline microbatches and ZeRO are refused (ROADMAP module
14).
"""

from __future__ import annotations

import os
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from imagetranslate_tpu_torch.data.loader import MassBatcher, MTBatcher
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
    make_mass_train_step,
    make_mt_train_step,
    mass_batch_to_device,
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
        the model trains; ``cuda`` fails without a card. ``mask_prob`` bounds
        where a MASS span may start; ``bt_beam_width`` is the beam of the
        back-translation decode (1: greedy)."""
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
        self.bt_beam_width = bt_beam_width
        self.max_len_a = max_len_a
        self.max_len_b = max_len_b
        self.len_penalty_ratio = len_penalty_ratio
        self.best_bleu = -1.0
        self.reference: List[str] = []
        self._host_step = 0
        self.optimizer = wrap_accum(
            build_optimizer(lr=lr, warmup_updates=warmup, clip_norm=clip),
            accum)
        self.mt_step = make_mt_train_step(self.model, self.optimizer,
                                          label_smoothing=label_smoothing)
        self.mass_step = make_mass_train_step(
            self.model, self.optimizer, cfg, mask_prob=mask_prob,
            n_specials=len(tp.special_tokens), mask_id=tp.mask_token_id(),
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
                    mass_batcher: Optional[MassBatcher] = None,
                    dev_batcher: Optional[MTBatcher] = None,
                    img_batcher=None, image_root: str = "",
                    max_step: int = 300_000, fine_tune: bool = False,
                    lang_directions: Optional[Dict[int, int]] = None,
                    eval_every: int = 5000, save_every: int = 10_000,
                    log_every: int = 50, epoch_seed: int = 0) -> int:
        from imagetranslate_tpu_torch.data.prefetch import PrefetchIterator
        from imagetranslate_tpu_torch.utils.metrics import AsyncStepMeter

        if img_batcher is not None and not hasattr(self, "_img_step"):
            raise ValueError("the image stream trains an ImageSeq2Seq: use "
                             "ImageMTTrainer (train/trainer_image_mt.py)")
        if fine_tune and mass_batcher is not None and not lang_directions:
            raise ValueError("fine_tune back-translates the mass stream and "
                             "needs lang_directions (see "
                             "MTTrainer.lang_directions)")
        streams = []
        if img_batcher is not None:
            self._cur_img_batcher = img_batcher
            streams.append(("img", img_batcher.shuffled(epoch_seed)))
        if mass_batcher is not None:
            streams.append(("mass", mass_batcher.shuffled(epoch_seed)))
        if mt_batcher is not None:
            streams.append(("mt", mt_batcher.shuffled(epoch_seed)))
        if not streams:
            return step

        def interleaved():
            # One batch from every stream per tick; the shortest stream ends
            # the epoch.
            while True:
                tick = []
                try:
                    for kind, it in streams:
                        tick.append((kind, next(it)))
                except StopIteration:
                    return
                yield from tick

        def stage(item):
            # Runs in the prefetch thread: staging batch N+1 onto the device
            # overlaps the step on batch N. A back-translation batch (the
            # mass stream in the fine-tune phase) stays on the host: its
            # step starts with a decode of the batch itself.
            kind, b = item
            if kind == "mt":
                to_dev = (packed_mt_batch_to_device if hasattr(b, "src_seg")
                          else mt_batch_to_device)
                return kind, b, to_dev(b, self.device)
            if kind == "img":
                return kind, b, self._stage_img(b, image_root)
            if not fine_tune:
                return kind, b, mass_batch_to_device(b, self.device)
            return kind, b, None

        meter = AsyncStepMeter(log_every=log_every)
        prefetcher = PrefetchIterator(interleaved(), stage, depth=3)
        try:
            for kind, b, staged in prefetcher:
                self._host_step = step + 1     # the image stream's draws
                if kind == "mt":
                    self.state, m = self.mt_step(self.state, staged, self.rng)
                elif kind == "img":
                    m = self._img_step(b, image_root, self.rng,
                                       images=staged)
                elif not fine_tune:
                    self.state, m = self.mass_step(self.state, staged,
                                                   self.rng)
                else:
                    m = self._bt_step(b, lang_directions, self.rng)
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

    def _bt_step(self, b, lang_directions: Dict[int, int], rng):
        """Back-translation of one MassBatch: decode each row into the other
        language with frozen weights (beam ``bt_beam_width``), then train on
        translating back."""
        tp = self.tp
        pad = tp.pad_token_id()
        lang_tok_of_row = np.asarray(b.src[:, 0])
        # Flip each row's language token through lang_directions.
        first_tokens = lang_tok_of_row.astype(np.int32).copy()
        for src_tok, dst_tok in lang_directions.items():
            first_tokens[lang_tok_of_row == src_tok] = dst_tok
        dst_lang_types = first_tokens.copy()
        for t in np.unique(first_tokens):
            dst_lang_types[first_tokens == t] = tp.languages.get(
                tp.id2token(int(t)), 0)

        best, lengths = self._decode_batch(
            b.src, b.src_mask, b.langs, first_tokens, dst_lang_types,
            b.lengths, beam_width=self.bt_beam_width)

        # The synthetic pairs: translation (closed by the separator at its
        # length) -> original.
        best, lengths = best.cpu().numpy(), lengths.cpu().numpy()
        N, T = best.shape
        trans = np.full((N, T + 1), pad, np.int32)
        keep = np.arange(T)[None, :] < lengths[:, None]
        trans[:, :T] = np.where(keep, best, pad)
        trans[np.arange(N), lengths] = tp.sep_token_id()
        batch = {
            "src": trans, "src_mask": trans != pad,
            "dst": b.src, "dst_mask": b.src_mask,
            "src_langs": dst_lang_types, "dst_langs": b.langs,
            "row_mask": b.row_mask,
        }
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in batch.items()}
        self.state, m = self.mt_step(self.state, batch, rng)
        return m

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
    def lang_directions(bt_langs: List[str],
                        tp: TextProcessor) -> Dict[int, int]:
        """{lang_token_id: other_lang_token_id} for exactly two languages."""
        ids = sorted({tp.token_id(f"<{lang}>") for lang in bt_langs})
        if len(ids) != 2:
            raise ValueError("back-translation needs exactly two languages, "
                             f"got {bt_langs}")
        return {ids[0]: ids[1], ids[1]: ids[0]}
