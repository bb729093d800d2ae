"""Caption -> image trainer (port of
imagetranslate_tpu/train/trainer_txt2image.py: ``Caption2ImageTrainer``).

Caption2Image learns to regress a frozen captioner's image grid from the
caption alone. The target grid is the captioner's ``encode_images`` at the
captioner's own ``img_size`` (its location table has (img_size/32)^2 slots),
in inference mode (running BatchNorm statistics, no gradient); a prefetch
thread decodes each batch's images and runs that encode while the previous
step trains. Dev loss, best-slot and ``.latest`` checkpoints as
``SenSimTrainer`` has them (a strictly lower dev loss saves).

Under a mesh each rank decodes and encodes the target grids of its own rows
only (the captioner is frozen and in inference mode: every row stands
alone), and the step averages over the global rows (train/step.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from imagetranslate_tpu_torch.data.images import CaptionBatcher
from imagetranslate_tpu_torch.models.caption2image import Caption2Image
from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.parallel.mesh import host_rows
from imagetranslate_tpu_torch.train.step import (
    _to,
    make_caption2image_train_step,
)
from imagetranslate_tpu_torch.train.trainer_sensim import BridgedTrainer
from imagetranslate_tpu_torch.train.weights import CAPTION2IMAGE


class Caption2ImageTrainer(BridgedTrainer):
    BRIDGE = CAPTION2IMAGE

    def __init__(self, cfg: Seq2SeqConfig, tp, caption_model, params=None,
                 lr: float = 1e-4, warmup: int = 4000, clip: float = 1.0,
                 mesh=None, seed: int = 0, device="cuda"):
        """``caption_model``: the frozen captioner, an ``ImageSeq2Seq`` with
        its weights (``cli.caption.load_captioner``), on ``device``.
        ``params``: a flax-layout ``Caption2Image`` tree to start from (None:
        random, from ``seed``)."""
        self.tp = tp
        self.caption_model = caption_model.eval()
        self.img_size = caption_model.cfg.img_size
        model = Caption2Image(cfg, device=torch.device(device)
                              if mesh is None else mesh.device,
                              param_dtype=torch.float32)
        self._setup(model, cfg, params, lr, warmup, clip, mesh, seed,
                    make_caption2image_train_step)

    @torch.no_grad()
    def _batch(self, b, image_root: str,
               split: bool = True) -> Dict[str, torch.Tensor]:
        """A CaptionBatch -> the step's dict on the device, its target grid
        from the frozen captioner; under a mesh (``split``) this rank's rows
        alone, their images copied and encoded here."""
        dev = self.device
        rows = (host_rows(b.captions.shape[0], self.mesh) if split
                else slice(None))
        images = _to(b.images(image_root, size=self.img_size, raw=True), dev,
                     rows)
        return {"src": _to(b.captions, dev, rows),
                "src_mask": _to(b.caption_mask, dev, rows),
                "src_langs": _to(b.langs, dev, rows),
                "target_grid": self.caption_model.encode_images(images),
                "row_mask": _to(b.row_mask, dev, rows)}

    def train_epoch(self, step: int, saving_path: str,
                    cap_batcher: CaptionBatcher, image_root: str = "",
                    dev_batcher: Optional[CaptionBatcher] = None,
                    max_step: int = 300_000, eval_every: int = 5000,
                    log_every: int = 50, epoch_seed: int = 0) -> int:
        evaluate = (None if dev_batcher is None else
                    lambda: self.eval(dev_batcher, image_root, saving_path))
        return self._epoch(step, saving_path,
                           cap_batcher.shuffled(epoch_seed),
                           lambda b: self._batch(b, image_root), evaluate,
                           max_step, eval_every, log_every)

    @torch.no_grad()
    def eval(self, dev_batcher: CaptionBatcher, image_root: str,
             saving_path: str) -> float:
        """The summed squared error of the grid a real row, averaged over
        the real rows; strictly below the best so far, the model is saved
        into ``saving_path``."""
        total, items = 0.0, 0
        for b in dev_batcher:
            batch = self._batch(b, image_root, split=False)
            grid = self.model(batch["src"], batch["src_mask"],
                              batch["src_langs"])
            err = torch.sum((grid - batch["target_grid"].to(torch.float32))
                            ** 2, dim=(1, 2))
            total += float(torch.sum(err * batch["row_mask"]))
            items += int(b.row_mask.sum())
        dev_loss = total / max(items, 1)
        if dev_loss < self.best_loss:
            self.best_loss = dev_loss
            self._save(saving_path, self.state.step)
        return dev_loss
