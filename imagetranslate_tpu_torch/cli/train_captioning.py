"""Captioning training CLI (port of imagetranslate_tpu/cli/train_captioning.py):
the same flags and defaults, plus ``--device``.

    python -m imagetranslate_tpu_torch.cli.train_captioning --tok TOKDIR \
        --model OUT --train cap.bin [--dev cap.dev.bin] --image IMGDIR \
        [--train_mt f.mt] [--lm MTDIR] [--mtlw 0.1] --step N [--device cuda]

``--lm`` starts the text core from an MT checkpoint; ``--train_mt`` adds the
MT stream (its batch and capacity budgets halved); ``--obj --obj-feats
detections.npz`` trains the object stream from precomputed detections.
``--mmode masked|contrastive|mixed`` trains the multimodal image streams
(multimodal MASS with a span rate drawn from U(``--mask``, 1), image-text
InfoNCE, or a coin per batch) in place of plain captioning.
``--pretrained`` is parsed and not used, as in the JAX CLI. Checkpoints are
the JAX package's captioning layout, so ``cli.caption`` of either package
captions with what this one trained.

A non-empty ``--mesh`` (ROADMAP module 14) stops the run with a message.
"""

from __future__ import annotations

import argparse
import os


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_captioning")
    p.add_argument("--tok", dest="tokenizer_path", required=True)
    p.add_argument("--model", dest="model_path", required=True)
    p.add_argument("--pretrained", dest="pretrained_path", default=None)
    p.add_argument("--train", dest="train_path", default=None)
    p.add_argument("--dev", dest="dev_path", default=None)
    p.add_argument("--image", dest="image_dir", default="")
    p.add_argument("--train_mt", dest="mt_train_path", default=None)
    p.add_argument("--lm", dest="lm_path", default=None,
                   help="pretrained MT model to graft into the text core")
    p.add_argument("--step", type=int, default=125000)
    p.add_argument("--epoch", dest="num_epochs", type=int, default=100)
    p.add_argument("--batch", type=int, default=20000)
    p.add_argument("--capacity", dest="total_capacity", type=int, default=600)
    p.add_argument("--img_capacity", type=int, default=50)
    p.add_argument("--max-image", dest="max_image", type=int, default=32)
    p.add_argument("--img-depth", dest="resnet_depth", type=int, default=1)
    p.add_argument("--lr", dest="learning_rate", type=float, default=0.0001)
    p.add_argument("--warmup", type=int, default=12500)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--acc", dest="accum", type=int, default=1)
    p.add_argument("--beam", dest="beam_width", type=int, default=5)
    p.add_argument("--len-penalty", dest="len_penalty_ratio", type=float,
                   default=0.8)
    p.add_argument("--mtlw", dest="mtl_weight", type=float, default=0.1)
    p.add_argument("--enc", dest="encoder_layer", type=int, default=6)
    p.add_argument("--dec", dest="decoder_layer", type=int, default=6)
    p.add_argument("--embed", dest="embed_dim", type=int, default=768)
    p.add_argument("--intermediate", dest="intermediate_layer_dim", type=int,
                   default=3072)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--attn-dropout", dest="attention_dropout", type=float,
                   default=None,
                   help="attention-probability dropout (default: --dropout); "
                        "0 disables it")
    p.add_argument("--tie", dest="tie_embed", action="store_true")
    p.add_argument("--ldec", dest="lang_decoder", action="store_true")
    p.add_argument("--fimg", dest="freeze_image", action="store_true")
    p.add_argument("--eval-every", type=int, default=5000)
    p.add_argument("--save-every", type=int, default=10000)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--mmode", dest="mm_mode", default=None,
                   choices=[None, "mixed", "masked", "contrastive"],
                   help="multimodal image-stream mode; default: plain "
                        "captioning")
    p.add_argument("--mask", dest="mask_prob", type=float, default=0.5,
                   help="the multimodal MASS span rate (with --mmode)")
    p.add_argument("--obj", dest="use_obj", action="store_true",
                   help="train the object stream (needs --obj-feats)")
    p.add_argument("--obj-feats", dest="obj_feats_path", default=None,
                   help="precomputed detections .npz")
    p.add_argument("--mesh", dest="mesh_spec", default="",
                   help="device mesh (not ported yet: one device)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")
    return p


def main(argv=None):
    options = get_parser().parse_args(argv)
    if options.mesh_spec:
        raise SystemExit("--mesh is not ported yet (multi-device training: "
                         "ROADMAP module 14)")
    if options.train_path is None:
        raise SystemExit("--train <caption binary> is required")
    if options.use_obj and options.obj_feats_path is None:
        raise SystemExit("--obj needs --obj-feats <detections.npz>")

    from imagetranslate_tpu_torch.data.binarize import load_mt
    from imagetranslate_tpu_torch.data.images import (
        CaptionBatcher,
        CaptionEvalSet,
        ObjectStore,
    )
    from imagetranslate_tpu_torch.data.loader import MTBatcher
    from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train.checkpoint import load_params
    from imagetranslate_tpu_torch.train.trainer_caption import CaptionTrainer

    tp = TextProcessor(options.tokenizer_path)
    if tp.pad_token_id() != 0:
        raise SystemExit("the tokenizer's <pad> must have id 0")

    cfg = Seq2SeqConfig(
        vocab_size=tp.vocab_size(),
        num_languages=max(1, len(tp.languages)),
        hidden_size=options.embed_dim,
        intermediate_size=options.intermediate_layer_dim,
        enc_layers=options.encoder_layer,
        dec_layers=options.decoder_layer,
        dropout=options.dropout,
        attention_dropout=(options.dropout
                           if options.attention_dropout is None
                           else options.attention_dropout),
        lang_dec=options.lang_decoder,
        tie_embed=options.tie_embed,
        resnet_depth=options.resnet_depth,
        freeze_image=options.freeze_image,
        use_obj=options.use_obj,
        dtype=options.dtype,
    )
    if cfg.hidden_size % cfg.num_heads:
        raise SystemExit(
            f"--embed {cfg.hidden_size} is not a multiple of the model's "
            f"{cfg.num_heads} attention heads (the CLI has no heads flag): "
            f"pick a multiple of {cfg.num_heads}")

    obj_store = None
    kw = {}
    if options.use_obj:
        obj_store = ObjectStore(options.obj_feats_path)
        kw["object_feat_dim"] = obj_store.feat_dim

    trainer = CaptionTrainer(
        cfg, tp, lr=options.learning_rate, warmup=options.warmup,
        clip=options.clip, accum=options.accum, beam_width=options.beam_width,
        len_penalty_ratio=options.len_penalty_ratio,
        mtl_weight=options.mtl_weight, mm_mode=options.mm_mode,
        mask_prob=options.mask_prob, device=options.device, **kw)

    if options.lm_path is not None:
        trainer.graft_mt_model(load_params(options.lm_path))
        print("Grafted pretrained MT model into the captioner")

    cap_batcher = CaptionBatcher(options.train_path, tp,
                                 max_capacity_mb=options.img_capacity,
                                 max_img_per_batch=options.max_image)
    print(f"Caption batches: {len(cap_batcher)}")
    eval_set = (CaptionEvalSet(options.dev_path, tp)
                if options.dev_path else None)

    mt_batcher = None
    if options.mt_train_path is not None:
        examples = []
        for path in options.mt_train_path.split(","):
            examples.extend(load_mt(path))
        mt_batcher = MTBatcher(examples, pad_id=0,
                               max_batch=options.batch // 2,
                               capacity_mb=options.total_capacity // 2)
        print(f"MT batches: {len(mt_batcher)}")

    os.makedirs(options.model_path, exist_ok=True)
    step, epoch = 0, 0
    while step < options.step and epoch < options.num_epochs:
        print(f"train epoch {epoch}")
        step = trainer.train_epoch(
            step, options.model_path, cap_batcher,
            image_root=options.image_dir, mt_batcher=mt_batcher,
            eval_set=eval_set, obj_store=obj_store, max_step=options.step,
            eval_every=options.eval_every, save_every=options.save_every,
            epoch_seed=epoch)
        epoch += 1
    print("Finished Training!")


if __name__ == "__main__":
    main()
