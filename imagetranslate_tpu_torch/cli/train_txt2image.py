"""Caption -> image training CLI (port of
imagetranslate_tpu/cli/train_txt2image.py): the same flags and defaults,
plus ``--device``.

    python -m imagetranslate_tpu_torch.cli.train_txt2image --tok TOKDIR \
        --model OUT --pretrained CAPTIONER --train cap.bin [--dev cap.dev.bin] \
        --image IMGDIR --step N [--device cuda]

Caption2Image learns, by L2 regression, the image grid that the frozen
captioner of ``--pretrained`` (a captioning checkpoint of either package)
encodes each caption's image to. A non-empty ``--mesh`` (ROADMAP module 14)
stops the run with a message.
"""

from __future__ import annotations

import argparse
import os

from imagetranslate_tpu_torch.cli.train_sensim import (
    add_encoder_flags,
    encoder_config,
)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_txt2image")
    p.add_argument("--tok", dest="tokenizer_path", required=True)
    p.add_argument("--model", dest="model_path", required=True)
    p.add_argument("--pretrained", dest="pretrained_path", required=True,
                   help="frozen captioner checkpoint (ImageSeq2Seq)")
    p.add_argument("--train", dest="train_path", required=True)
    p.add_argument("--dev", dest="dev_path", default=None)
    p.add_argument("--image", dest="image_dir", default="")
    p.add_argument("--step", type=int, default=125000)
    p.add_argument("--img_capacity", type=int, default=50)
    p.add_argument("--max-image", dest="max_image", type=int, default=32)
    add_encoder_flags(p)
    return p


def main(argv=None):
    options = get_parser().parse_args(argv)

    from imagetranslate_tpu_torch.cli.caption import load_captioner
    from imagetranslate_tpu_torch.data.images import CaptionBatcher
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train.trainer_txt2image import (
        Caption2ImageTrainer,
    )

    tp = TextProcessor(options.tokenizer_path)
    cfg = encoder_config(options, tp)
    captioner = load_captioner(options.pretrained_path, options.device)
    trainer = Caption2ImageTrainer(cfg, tp, captioner,
                                   lr=options.learning_rate,
                                   warmup=options.warmup, clip=options.clip,
                                   device=options.device)

    cap_batcher, dev_batcher = (
        CaptionBatcher(path, tp, max_capacity_mb=options.img_capacity,
                       max_img_per_batch=options.max_image)
        if path else None
        for path in (options.train_path, options.dev_path))

    os.makedirs(options.model_path, exist_ok=True)
    step, epoch = 0, 0
    while step < options.step:
        print(f"train epoch {epoch}")
        step = trainer.train_epoch(step, options.model_path, cap_batcher,
                                   image_root=options.image_dir,
                                   dev_batcher=dev_batcher,
                                   max_step=options.step, epoch_seed=epoch)
        epoch += 1
    print("Finished Training!")


if __name__ == "__main__":
    main()
