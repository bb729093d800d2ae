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

The model holds fp32 master parameters and computes in ``cfg.dtype``.

Under a mesh (``parallel.mesh.ProcessMesh``, one process a rank) the model
keeps this rank's shard of the JAX TP rules, each step takes this rank's
rows of the batch (every rank builds the same batches and copies only its
rows to its device, as JAX ``put_global`` uploads only a process's shard)
and the steps hold the global batch semantics (train/step.py). The dev
and back-translation decodes split the rows over the data group and decode
through K2b across the model group. Checkpoints hold the gathered full
state in the one-device layout, written by rank 0; every rank loads the
full state and shards it. Only rank 0 logs.

``zero=True`` (ZeRO-1, parallel/zero.py) keeps this rank's slices of the
split tensors' Adam moments (and of the accumulated gradients under
``accum``) over the data group; the numbers are those without it, and a
checkpoint gathers the slices into the one-device layout. ``pp_microbatches
= M`` (parallel/pipeline.py) makes the model axis the pipeline axis: the
rank holds its stage's layers (``PipelineStage``), each step runs the GPipe
schedule over M microbatches, the dev and back-translation decodes run on the
one-device model the stages gather, and checkpoints carry the weights and
the step only.
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
from imagetranslate_tpu_torch.parallel.comm import all_gather_stack
from imagetranslate_tpu_torch.parallel.mesh import (
    ProcessMesh,
    gather_params,
    host_rows,
    shard_params,
)
from imagetranslate_tpu_torch.parallel.pipeline import (
    PipelineStage,
    gather_pipeline_params,
    make_mass_train_step_pp,
    make_mt_train_step_pp,
    split_pipeline_params,
)
from imagetranslate_tpu_torch.parallel.zero import ZeroLayout
from imagetranslate_tpu_torch.text.processor import TextProcessor
from imagetranslate_tpu_torch.train.checkpoint import save_checkpoint
from imagetranslate_tpu_torch.train.optimizer import (
    build_optimizer,
    map_moments,
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
    SEQ2SEQ,
    flax_from_opt_state,
    flax_from_state_dict,
    opt_state_from_flax,
    random_params,
    state_dict_from_flax,
)


class MTTrainer:
    mesh: Optional[ProcessMesh] = None
    chief = True    # rank 0 of the mesh, or no mesh: logs and writes
    plan = None     # under a mesh: state_dict key -> split dim or None
    # Read as "off" by subclasses that build their own state
    # (ImageMTTrainer): pipeline microbatches, ZeRO-1's layout.
    pp = 0
    zero = None
    _merged = None  # under PP: ((state, step), the one-device Seq2Seq)

    def __init__(self, cfg: Seq2SeqConfig, tp: TextProcessor,
                 params=None, lr: float = 1e-4, warmup: int = 4000,
                 clip: float = 1.0, accum: int = 1, mask_prob: float = 0.5,
                 beam_width: int = 4, bt_beam_width: int = 1,
                 max_len_a: float = 1.1, max_len_b: int = 5,
                 len_penalty_ratio: float = 0.8, label_smoothing: float = 0.1,
                 mesh: Optional[ProcessMesh] = None, seed: int = 0,
                 pp_microbatches: int = 0, zero: bool = False,
                 device="cuda"):
        """``params``: a flax-layout parameter tree to start from (None:
        random, the JAX model's initializers from ``seed``). ``device``: where
        the model trains; ``cuda`` fails without a card; under a ``mesh``
        the mesh's device. ``mask_prob`` bounds where a MASS span may start;
        ``bt_beam_width`` is the beam of the back-translation decode (1:
        greedy)."""
        self.pp = int(pp_microbatches)
        if self.pp and cfg.moe_experts:
            raise ValueError(
                "MoE + pipeline parallelism is unsupported: the staged "
                "pipeline step (parallel/pipeline.py) does not plumb the "
                "MoE load-balance aux loss; train MoE with dp/tp/ep "
                "(--mesh without --pp-microbatches)")
        if self.pp and (mesh is None or mesh.n_model <= 1):
            raise SystemExit(
                "--pp-microbatches needs a --mesh with a model axis > 1 "
                "(its size becomes the pipeline-stage count)")
        self.cfg = cfg
        self.tp = tp
        self.mesh = mesh
        self.chief = mesh is None or mesh.rank == 0
        self.device = torch.device(device) if mesh is None else mesh.device
        if self.pp:
            self.model = PipelineStage(cfg, mesh, device=self.device,
                                       param_dtype=torch.float32)
        else:
            self.model = Seq2Seq(cfg, device=self.device,
                                 param_dtype=torch.float32)
            self.plan = None if mesh is None else self.model.shard_(mesh)
        # The dropout seeds: the same stream on every rank.
        self.rng = torch.Generator().manual_seed(seed)
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
        if mesh is not None and mesh.model_group is not None:
            self.optimizer.set_tensor_parallel(
                mesh.model_group, self.model.layer_names() if self.pp else
                [k for k, dim in self.plan.items() if dim is not None])
        if zero and mesh is not None and mesh.n_data > 1:
            self.zero = ZeroLayout(
                {k: p.shape for k, p in self.model.named_parameters()}, mesh,
                cfg, self.plan)
            self.optimizer.set_zero(self.zero)
        specials = dict(n_specials=len(tp.special_tokens),
                        mask_id=tp.mask_token_id(),
                        label_smoothing=label_smoothing)
        if self.pp:
            self.mt_step = make_mt_train_step_pp(
                self.model, self.optimizer, self.pp,
                label_smoothing=label_smoothing)
            self.mass_step = make_mass_train_step_pp(
                self.model, self.optimizer, self.pp, mask_prob=mask_prob,
                **specials)
        else:
            self.mt_step = make_mt_train_step(
                self.model, self.optimizer, label_smoothing=label_smoothing)
            self.mass_step = make_mass_train_step(
                self.model, self.optimizer, cfg, mask_prob=mask_prob,
                **specials)
        self.set_reference_params(
            random_params(cfg, seed) if params is None else params)

    # ---------------- decoding helpers ----------------

    @torch.no_grad()
    def _decode_batch(self, src, src_mask, src_langs, first_tokens, tgt_langs,
                      src_sizes, beam_width: int,
                      max_len: Optional[int] = None):
        """Rows pad to the next power of two (>= 8), as the JAX trainer pads
        them: padded rows carry src_size 0 and freeze within a few steps, and
        keeping them keeps the loop's early exit the same. Under a mesh
        whose data axis divides the rows, each data rank decodes its slice
        of them and every rank returns all of them."""
        n = src.shape[0]
        rows = max(8, 1 << (int(n) - 1).bit_length())
        mesh = self.mesh
        split = (mesh is not None and mesh.data_group is not None
                 and rows % mesh.n_data == 0)
        lo, hi = 0, rows
        if split:
            lo, hi = (mesh.d * rows // mesh.n_data,
                      (mesh.d + 1) * rows // mesh.n_data)

        def dev(a):
            a = np.asarray(a)
            if a.shape[0] != rows:
                a = np.pad(a, [(0, rows - a.shape[0])]
                           + [(0, 0)] * (a.ndim - 1))
            return torch.as_tensor(a[lo:hi]).to(self.device)

        model = self.decode_model()
        mask = dev(src_mask)
        enc = model.encode(dev(src), mask, dev(src_langs))
        L = max_len or max_len_for(src.shape[1], self.max_len_a,
                                   self.max_len_b,
                                   self.cfg.max_position_embeddings)
        L = min(-(-L // 16) * 16, self.cfg.max_position_embeddings)
        best, lengths = beam_search(
            model, enc, mask, dev(first_tokens), dev(tgt_langs),
            dev(src_sizes), beam_width=beam_width, max_len=L,
            max_len_a=self.max_len_a, max_len_b=self.max_len_b,
            len_penalty_ratio=self.len_penalty_ratio,
            pad_id=self.tp.pad_token_id(), eos_id=self.tp.sep_token_id(),
            data_group=mesh.data_group if split else None)
        if split:
            best = all_gather_stack(best, mesh.data_group).flatten(0, 1)
            lengths = all_gather_stack(lengths, mesh.data_group).flatten()
        return best[:n], lengths[:n]

    def decode_model(self) -> Seq2Seq:
        """The model the decodes run: the trainer's own, or under PP the
        one-device model the stages gather (collective over the model
        group; kept until the parameters move)."""
        if not self.pp:
            return self.model
        key = (id(self.state), self.state.step)
        if self._merged is None or self._merged[0] != key:
            model = Seq2Seq(self.cfg, device=self.device,
                            param_dtype=torch.float32)
            model.load_state_dict(self._full(self.model.state_dict()))
            self._merged = (key, model.eval())
        return self._merged[1]

    # ---------------- train loops ----------------

    def train_epoch(self, step: int, saving_path: str,
                    mt_batcher: Optional[MTBatcher] = None,
                    mass_batcher: Optional[MassBatcher] = None,
                    dev_batcher: Optional[MTBatcher] = None,
                    img_batcher=None, image_root: str = "",
                    max_step: int = 300_000, fine_tune: bool = False,
                    lang_directions: Optional[Dict[int, int]] = None,
                    eval_every: int = 5000, save_every: int = 10_000,
                    log_every: int = 50, epoch_seed: int = 0,
                    profile_dir: Optional[str] = None) -> int:
        """Train one epoch from ``step``; returns the step reached.
        ``profile_dir``: write a ``torch.profiler`` trace of steps step + 10
        .. step + 15 there (``utils/profiling.py``)."""
        from imagetranslate_tpu_torch.data.prefetch import PrefetchIterator
        from imagetranslate_tpu_torch.utils.metrics import AsyncStepMeter
        from imagetranslate_tpu_torch.utils.profiling import StepProfiler

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
                return kind, b, to_dev(b, self.device, rows=host_rows(
                    b.src.shape[0], self.mesh))
            if kind == "img":
                return kind, b, self._stage_img(b, image_root)
            if not fine_tune:
                return kind, b, mass_batch_to_device(
                    b, self.device, rows=host_rows(b.src.shape[0], self.mesh))
            return kind, b, None

        meter = AsyncStepMeter(log_every=log_every, quiet=not self.chief)
        profiler = StepProfiler(profile_dir if self.chief else None,
                                start=step + 10, stop=step + 15)
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
                profiler.tick(step)
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
            # A loop that ends or raises inside the window still writes it.
            profiler.close()

        meter.finish(step)
        if self.chief:
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
            if self.chief:
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
        rows = host_rows(N, self.mesh)
        batch = {k: torch.as_tensor(v[rows]).to(self.device)
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
        """Decode the dev set, then score it (sacrebleu is imported after
        the decode: without it the decode runs and the scoring raises)."""
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

        import sacrebleu

        bleu = sacrebleu.corpus_bleu(mt_output,
                                     [self.reference[:len(mt_output)]],
                                     lowercase=True, tokenize="intl")
        best = bleu.score > self.best_bleu
        if best:
            self.best_bleu = bleu.score
            # Every rank gathers the state; rank 0 writes it.
            self._save(saving_path, step=self.state.step)
        if not self.chief:
            return bleu.score
        os.makedirs(saving_path, exist_ok=True)
        transcript = "\n".join(
            s + "\n" + o + "\n" + r + "\n\n***************\n"
            for s, o, r in zip(src_text, mt_output,
                               self.reference[:len(mt_output)]))
        with open(os.path.join(saving_path, "bleu.output"), "w") as w:
            w.write(transcript)
        if best:
            print(f"Saving best BLEU {self.best_bleu:.2f}", flush=True)
            with open(os.path.join(saving_path, "bleu.best.output"),
                      "w") as w:
                w.write(transcript)
        return bleu.score

    def _build_reference(self, dev_batcher: MTBatcher):
        self.reference = []
        for b in dev_batcher:
            for i in range(int(b.row_mask.sum())):
                self.reference.append(self.tp.decode(self._strip(b.dst[i])))

    # ---------------- persistence / phases ----------------

    def _full(self, sd):
        """The model's state_dict on this rank -> the one-device state_dict
        (collective over the model group under a mesh: the TP shards
        gathered, or the pipeline stages merged)."""
        if self.pp:
            return gather_pipeline_params(self.model)
        return sd if self.mesh is None else gather_params(sd, self.mesh,
                                                          self.plan)

    def _local(self, sd):
        """A dict of full tensors -> this rank's shards (or stage)."""
        if self.pp:
            return split_pipeline_params(sd, self.cfg, self.mesh.n_model,
                                         self.mesh.m)
        return sd if self.mesh is None else shard_params(sd, self.mesh,
                                                         self.plan)

    def _full_moments(self, sd):
        """A moment dict on this rank -> the one-device layout (collective:
        ZeRO's slices gathered over the data group, then ``_full``)."""
        if self.zero is not None:
            sd = self.zero.full_dict(sd, {k: p.shape for k, p in
                                          self.state.params.items()})
        return gather_params(sd, self.mesh, self.plan) if self.mesh else sd

    def _local_moments(self, sd):
        """The inverse of ``_full_moments``."""
        sd = self._local(sd)
        return sd if self.zero is None else self.zero.local_dict(sd)

    def params_tree(self) -> dict:
        """The fp32 master parameters as the flax-layout tree (gathered
        under a mesh: every rank calls it)."""
        return flax_from_state_dict(self._full(self.model.state_dict()),
                                    self.cfg)

    def _save(self, path: str, step: int):
        """Every rank gathers; rank 0 writes the one-device layout. Under PP
        the weights and the step only: the moments are the stages' (JAX
        keeps them stage-stacked and bound to the geometry), so a resumed
        run keeps its schedule step and restarts Adam's moments."""
        params = self.params_tree()
        if self.pp:
            if self.chief:
                save_checkpoint(path, self.cfg, params, step=step,
                                best_metric=self.best_bleu)
            return
        opt_state = flax_from_opt_state(
            map_moments(self.state.opt_state, self._full_moments),
            self.optimizer, self.cfg)
        if self.chief:
            save_checkpoint(path, self.cfg, params, opt_state=opt_state,
                            step=step, best_metric=self.best_bleu)

    def set_reference_params(self, params, step: int = 0):
        """Replace the model weights from a flax-layout tree (the full
        state; sharded here under a mesh, split into the stage under PP) and
        reset the optimizer state to match. ``step`` (a checkpoint's saved
        step) re-seats the LR schedule there (PP checkpoints carry the
        weights and the step only)."""
        self._merged = None
        self.model.load_state_dict(
            self._local(state_dict_from_flax(params, self.cfg)))
        self.state = create_train_state(dict(self.model.named_parameters()),
                                        self.optimizer)
        if step:
            set_schedule_step(self.state.opt_state, step)

    def load_opt_state(self, tree, bridge=SEQ2SEQ):
        """The optimizer state from a checkpoint's optax tree (the full
        state; sharded here under a mesh, sliced under ZeRO: JAX's
        ``_maybe_zero`` after a restore)."""
        if self.pp:
            raise ValueError(
                "--cont with --pp-microbatches: optimizer moments are "
                "stage-stacked and geometry-bound; PP restores weights "
                "+ step only (drop --cont)")
        self.state.opt_state = map_moments(
            opt_state_from_flax(tree, self.optimizer, self.cfg, self.device,
                                bridge), self._local_moments)

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
