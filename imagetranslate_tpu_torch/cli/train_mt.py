"""MT / MASS / back-translation training CLI (port of
imagetranslate_tpu/cli/train_mt.py): the same flags and defaults, plus
``--device``.

    python -m imagetranslate_tpu_torch.cli.train_mt --tok TOKDIR --model OUT \
        --train_mt train.mt [--dev_mt dev.mt] --step N [--device cuda]

Unsupervised MT: MASS pretraining on monolingual shards for ``--step`` steps,
then ``--fstep`` steps of back-translation between the two ``--langs``:

    python -m imagetranslate_tpu_torch.cli.train_mt --tok TOKDIR --model OUT \
        --mass_train PREFIX --step N --fstep M --langs aa,bb [--device cuda]

``--pack`` packs the MT stream's examples into rows of 256 source and 256
target tokens, 64 rows a batch (data/packing.py); ``--profile DIR`` writes a
``torch.profiler`` trace of the first epoch's steps 10-15 into DIR.

``--train_mt`` and ``--mass_train`` read marshal files or ITR1 record files
(``cli.create_mt_batches --packed``): one ITR1 ``.mt`` file, or MASS shards
that are all ITR1, are batched straight from their mapping
(``from_packed``).

``--lm LMDIR`` starts the embeddings, the encoder and (when it is untied) the
output layer from a checkpoint of ``cli.train_lm``. ``--moe-experts N
--moe-top-k K`` puts a routed bank of N experts in every layer's FFN, its
load-balance loss in every step.

Multimodal MT: ``--train CAPTIONS.bin --image IMGDIR`` adds an image-caption
stream (``ImageMTTrainer``), trained by ``--mmode`` ("mixed", "masked":
multimodal MASS, "contrastive": image-text InfoNCE), with ``--img-depth`` the
ResNet; in the ``--fstep`` phase the image batches keep flowing beside
back-translation. ``--pretrained`` then takes a multimodal checkpoint, or a
text one whose weights become the text core. ``--lm`` with ``--train`` is
refused (the JAX CLI ignores ``--lm`` there).

Data and tensor parallelism: ``--mesh DxM`` under torchrun, one process a
rank, D x M = the number of ranks (parallel/mesh.py):

    torchrun --nproc-per-node 4 -m imagetranslate_tpu_torch.cli.train_mt \
        --mesh 2x2 --tok TOKDIR --model OUT --train_mt train.mt ...

Every rank builds the same batches and trains on its rows; rank 0 writes
the checkpoints (the one-device layout) and logs. Under a mesh, ``--zero``
splits the optimizer state over the data axis (ZeRO-1), ``--pp-microbatches
M`` makes the model axis M-microbatch GPipe pipeline stages, and
``--moe-experts N`` splits each bank's experts over the model axis (expert
parallelism):

    torchrun --nproc-per-node 4 -m imagetranslate_tpu_torch.cli.train_mt \
        --mesh 2x2 --zero ...
    torchrun --nproc-per-node 4 -m imagetranslate_tpu_torch.cli.train_mt \
        --mesh 1x4 --pp-microbatches 4 ...
    torchrun --nproc-per-node 4 -m imagetranslate_tpu_torch.cli.train_mt \
        --mesh 2x2 --moe-experts 8 ...

A pipelined run's checkpoints hold the weights and the step: ``--cont`` with
``--pp-microbatches`` is refused, ``--pretrained`` resumes the schedule at
the saved step. The image stream (``--train``) takes ``--mesh`` and
``--zero`` too (the pipeline is refused there):

    torchrun --nproc-per-node 2 -m imagetranslate_tpu_torch.cli.train_mt \
        --mesh 2x1 --zero --train CAPTIONS.bin --image IMGDIR ...

Checkpoints are the JAX package's directory layout, so either package resumes
from and translates with what the other trained.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os

def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_mt")
    p.add_argument("--tok", dest="tokenizer_path", required=True)
    p.add_argument("--model", dest="model_path", required=True)
    p.add_argument("--pretrained", dest="pretrained_path", default=None)
    p.add_argument("--epoch", dest="num_epochs", type=int, default=100)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--batch", type=int, default=20000)
    p.add_argument("--mask", dest="mask_prob", type=float, default=0.5)
    p.add_argument("--lr", dest="learning_rate", type=float, default=0.0001)
    p.add_argument("--warmup", type=int, default=12500)
    p.add_argument("--step", type=int, default=125000)
    p.add_argument("--fstep", dest="finetune_step", type=int, default=0)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--attn-dropout", dest="attention_dropout", type=float,
                   default=None,
                   help="attention-probability dropout (default: --dropout); "
                        "0 disables it")
    p.add_argument("--enc", dest="encoder_layer", type=int, default=6)
    p.add_argument("--dec", dest="decoder_layer", type=int, default=6)
    p.add_argument("--embed", dest="embed_dim", type=int, default=768)
    p.add_argument("--intermediate", dest="intermediate_layer_dim", type=int,
                   default=3072)
    p.add_argument("--capacity", dest="total_capacity", type=int, default=600)
    p.add_argument("--moe-experts", dest="moe_experts", type=int, default=0,
                   help="Mixture-of-Experts FFN with this many experts per "
                        "layer (models/moe.py); 0 = dense")
    p.add_argument("--moe-top-k", dest="moe_top_k", type=int, default=2,
                   help="experts routed per token")
    p.add_argument("--beam", dest="beam_width", type=int, default=5)
    p.add_argument("--bt-beam", dest="bt_beam_width", type=int, default=1)
    p.add_argument("--max_len_a", type=float, default=1.3)
    p.add_argument("--max_len_b", type=int, default=5)
    p.add_argument("--len-penalty", dest="len_penalty_ratio", type=float,
                   default=0.8)
    p.add_argument("--max_seq_len", type=int, default=175)
    p.add_argument("--ldec", dest="lang_decoder", action="store_true")
    p.add_argument("--nll", dest="nll_loss", action="store_true")
    p.add_argument("--tie", dest="tie_embed", action="store_true")
    p.add_argument("--dev_mt", dest="mt_dev_path", default=None)
    p.add_argument("--train_mt", dest="mt_train_path", default=None)
    p.add_argument("--mass_train", dest="mass_train_path", default=None)
    p.add_argument("--train", dest="train_path", default=None)
    p.add_argument("--image", dest="image_dir", default="")
    p.add_argument("--img_capacity", type=int, default=50)
    p.add_argument("--max-image", dest="max_image", type=int, default=32)
    p.add_argument("--img-depth", dest="resnet_depth", type=int, default=1)
    p.add_argument("--mmode", dest="mm_mode", default="mixed",
                   choices=["mixed", "masked", "contrastive"])
    p.add_argument("--langs", dest="bt_langs", default="")
    p.add_argument("--acc", dest="accum", type=int, default=1)
    p.add_argument("--ignore-mt-mass", dest="ignore_mt_mass",
                   action="store_true")
    p.add_argument("--save-opt", dest="save_opt", action="store_true",
                   help="accepted for compatibility; optimizer state is "
                        "always saved")
    p.add_argument("--cont", dest="continue_train", action="store_true")
    p.add_argument("--eval-every", type=int, default=5000)
    p.add_argument("--save-every", type=int, default=10000)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--profile", dest="profile_dir", default=None)
    p.add_argument("--dict", dest="dict_path", default=None,
                   help="lexical proposal dictionary")
    p.add_argument("--lm", dest="lm_path", default=None)
    p.add_argument("--bucket_step", type=int, default=16,
                   help="length bucket multiple")
    p.add_argument("--pack", dest="pack_mt", action="store_true")
    p.add_argument("--mesh", dest="mesh_spec", default="")
    p.add_argument("--pp-microbatches", dest="pp_microbatches", type=int,
                   default=0)
    p.add_argument("--zero", dest="zero", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")
    return p


def main(argv=None):
    parser = get_parser()
    options = parser.parse_args(argv)
    if options.train_path is not None and options.pp_microbatches:
        raise SystemExit("--pp-microbatches supports the text MT/MASS "
                         "trainer only (the image trainer's multimodal "
                         "forward is not pipelined)")
    if options.train_path is not None and options.lm_path is not None:
        raise SystemExit("--lm with --train: the image trainer starts from "
                         "--pretrained (the JAX CLI ignores --lm there)")
    if options.pp_microbatches and options.continue_train:
        raise SystemExit(
            "--cont with --pp-microbatches: optimizer moments are "
            "stage-stacked and geometry-bound; PP restores weights "
            "+ step only (drop --cont)")

    bt_langs = [lang for lang in options.bt_langs.strip().split(",") if lang]
    if options.finetune_step > 0 and len(set(bt_langs)) != 2:
        raise SystemExit("--fstep back-translates between exactly two "
                         f"languages: give --langs aa,bb (got "
                         f"{options.bt_langs!r})")

    from imagetranslate_tpu_torch.data.binarize import load_mass, load_mt
    from imagetranslate_tpu_torch.data.loader import (
        MassBatcher,
        MTBatcher,
        get_lex_dict,
    )
    from imagetranslate_tpu_torch.data.recordio import PackedReader, is_packed
    from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train.checkpoint import (
        load_checkpoint,
        load_config,
        load_params,
        load_variables,
    )
    from imagetranslate_tpu_torch.train.trainer_image_mt import (
        ImageMTTrainer,
    )
    from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer
    from imagetranslate_tpu_torch.train.weights import (
        CAPTION_PARAMS,
        SEQ2SEQ,
    )

    from imagetranslate_tpu_torch.parallel.mesh import cli_mesh, leave

    # joined: this run joined the process group (and leaves it).
    mesh, joined = cli_mesh(options.mesh_spec, options.device)
    if options.zero and mesh is None:
        raise SystemExit("--zero shards optimizer state over the mesh's "
                         "data axis; pass --mesh (e.g. --mesh 8x1)")

    tp = TextProcessor(options.tokenizer_path)
    if tp.pad_token_id() != 0:
        raise SystemExit("the tokenizer's <pad> must have id 0")
    lex_dict = (get_lex_dict(options.dict_path)
                if options.dict_path is not None else None)

    if options.pretrained_path is not None:
        cfg = load_config(options.pretrained_path)
        if options.train_path is not None:
            cfg = dataclasses.replace(cfg, resnet_depth=options.resnet_depth)
    else:
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
            use_proposals=lex_dict is not None,
            resnet_depth=options.resnet_depth,
            dtype=options.dtype,
            moe_experts=options.moe_experts,
            moe_top_k=options.moe_top_k,
        )

    if cfg.hidden_size % cfg.num_heads:
        raise SystemExit(
            f"--embed {cfg.hidden_size} is not a multiple of the model's "
            f"{cfg.num_heads} attention heads (the CLI has no heads flag): "
            f"pick a multiple of {cfg.num_heads}")
    if options.finetune_step > 0:
        missing = [lang for lang in bt_langs
                   if f"<{lang}>" not in tp.languages]
        if missing:
            raise SystemExit(f"--langs {options.bt_langs!r}: the tokenizer "
                             f"has no language token for {missing} (it has "
                             f"{sorted(tp.languages)})")

    trainer_kwargs = dict(
        lr=options.learning_rate, warmup=options.warmup,
        clip=options.clip, accum=options.accum, mask_prob=options.mask_prob,
        beam_width=options.beam_width, bt_beam_width=options.bt_beam_width,
        max_len_a=options.max_len_a, max_len_b=options.max_len_b,
        len_penalty_ratio=options.len_penalty_ratio,
        label_smoothing=0.0 if options.nll_loss else 0.1,
        device=options.device)
    if mesh is not None:
        trainer_kwargs["mesh"] = mesh
    if options.train_path is not None:
        trainer = ImageMTTrainer(cfg, tp, mm_mode=options.mm_mode,
                                 zero=options.zero, **trainer_kwargs)
    else:
        trainer = MTTrainer(cfg, tp, zero=options.zero,
                            pp_microbatches=options.pp_microbatches,
                            **trainer_kwargs)

    if options.lm_path is not None:
        lm = load_params(options.lm_path)["params"]
        p = dict(trainer.params_tree()["params"])
        p["embeddings"], p["encoder"] = lm["embeddings"], lm["encoder"]
        # An untied output layer takes the word table transposed and the
        # MLM's bias (the MLM head is tied to the word embeddings).
        if not cfg.tie_embed and "output_layers_0" in p:
            p["output_layers_0"] = {"proj": {
                "kernel": lm["embeddings"]["word"]["embedding"].T,
                "bias": lm["out_bias"]}}
        trainer.set_reference_params({"params": p})
        print("Initialized encoder/embeddings/output from the MLM LM")

    if options.pretrained_path is not None:
        params, opt_tree, meta = load_checkpoint(
            options.pretrained_path, with_opt_state=options.continue_train)
        bridge = SEQ2SEQ
        if options.train_path is not None:
            variables = load_variables(options.pretrained_path)
            if "image_model" in variables.get("params", {}):
                # A multimodal checkpoint: every weight and statistic.
                params, bridge = variables, CAPTION_PARAMS
            else:
                # A text model (the MASS-then-multimodal recipe): its
                # weights become the text core; the rest stays as drawn.
                trainer.graft_mt_model(params)
                params = opt_tree = None
        if params is not None:
            # A pipelined run's checkpoint holds weights and step: the
            # schedule resumes at the saved step.
            trainer.set_reference_params(
                params, step=int(meta.get("step", 0))
                if options.pp_microbatches else 0)
        if opt_tree is not None:
            trainer.load_opt_state(opt_tree, bridge)
        print(f"Restored pretrained model (step {meta.get('step', 0)})")

    pad = tp.pad_token_id()

    def batcher(paths, max_batch, capacity_mb):
        examples = []
        for path in paths.split(","):
            examples.extend(load_mt(path))
        return MTBatcher(examples, pad_id=pad, max_batch=max_batch,
                         capacity_mb=capacity_mb,
                         max_seq_len=options.max_seq_len,
                         bucket_step=options.bucket_step, lex_dict=lex_dict)

    mt_batcher = None
    if options.mt_train_path is not None and options.pack_mt:
        from imagetranslate_tpu_torch.data.packing import (
            PackedMTBatcher,
            packing_efficiency,
        )

        examples = []
        for path in options.mt_train_path.split(","):
            examples.extend(load_mt(path))
        mt_batcher = PackedMTBatcher(examples, pad_id=pad,
                                     max_seq_len=options.max_seq_len)
    elif options.mt_train_path is not None:
        paths = options.mt_train_path.split(",")
        if len(paths) == 1 and is_packed(paths[0]):
            # One ITR1 file: batches straight from its mapping.
            mt_batcher = MTBatcher.from_packed(
                PackedReader(paths[0]), pad_id=pad,
                max_batch=options.batch // 2,
                capacity_mb=options.total_capacity // 2,
                max_seq_len=options.max_seq_len,
                bucket_step=options.bucket_step, lex_dict=lex_dict)
        else:
            mt_batcher = batcher(options.mt_train_path, options.batch // 2,
                                 options.total_capacity // 2)
    if mt_batcher is not None:
        if len(mt_batcher) == 0:
            raise SystemExit(f"--train_mt {options.mt_train_path!r} matched "
                             "no examples: refusing to train on an empty "
                             "stream")
        if options.pack_mt:
            eff = packing_efficiency(mt_batcher.batches)
            print(f"MT train batches: {len(mt_batcher)} (packed, "
                  f"{eff:.0%} of target slots carry real tokens)")
        else:
            print(f"MT train batches: {len(mt_batcher)}")

    def build_mass_batcher(max_batch, capacity_mb):
        """ITR1 shards batch one shard at a time (their batches
        concatenate); marshal shards go through the list batcher."""
        shards = [path for prefix in options.mass_train_path.split(",")
                  for path in sorted(glob.glob(prefix + "*"))]
        if shards and all(is_packed(path) for path in shards):
            out = None
            for path in shards:
                nb = MassBatcher.from_packed(
                    PackedReader(path), pad_id=pad, max_batch=max_batch,
                    capacity_mb=capacity_mb, max_seq_len=options.max_seq_len,
                    bucket_step=options.bucket_step)
                if out is None:
                    out = nb
                else:
                    out.batches.extend(nb.batches)
            return out
        examples = []
        for prefix in options.mass_train_path.split(","):
            examples.extend(load_mass(prefix))
        return MassBatcher(examples, pad_id=pad, max_batch=max_batch,
                           capacity_mb=capacity_mb,
                           max_seq_len=options.max_seq_len,
                           bucket_step=options.bucket_step)

    mass_batcher = None
    if options.mass_train_path is not None:
        mass_batcher = build_mass_batcher(options.batch,
                                          options.total_capacity)
        if len(mass_batcher) == 0:
            raise SystemExit(
                f"--mass_train {options.mass_train_path!r} matched no "
                "examples (shards are globbed as '<prefix>*', e.g. out.0, "
                "out.1 from data.binarize.write_mt): refusing to train on "
                "an empty stream")
        print(f"MASS train batches: {len(mass_batcher)}")

    img_batcher = None
    if options.train_path is not None:
        from imagetranslate_tpu_torch.data.images import CaptionBatcher

        img_batcher = CaptionBatcher(options.train_path, tp,
                                     max_capacity_mb=options.img_capacity,
                                     max_img_per_batch=options.max_image,
                                     bucket_step=options.bucket_step)
        print(f"Image caption batches: {len(img_batcher)}")

    dev_batcher = None
    if options.mt_dev_path is not None:
        dev_batcher = batcher(
            options.mt_dev_path,
            int(options.batch / (options.beam_width * 2)),
            options.total_capacity)
        print(f"MT dev batches: {len(dev_batcher)}")

    os.makedirs(options.model_path, exist_ok=True)
    step, epoch = 0, 0
    while options.step > 0 and step < options.step:
        print(f"train epoch {epoch}")
        step_before = step
        step = trainer.train_epoch(
            step, options.model_path, mt_batcher=mt_batcher,
            mass_batcher=mass_batcher, dev_batcher=dev_batcher,
            img_batcher=img_batcher, image_root=options.image_dir,
            max_step=options.step, eval_every=options.eval_every,
            save_every=options.save_every, epoch_seed=epoch,
            profile_dir=options.profile_dir if epoch == 0 else None)
        if step == step_before:
            raise SystemExit("an epoch produced zero train steps (all "
                             "streams empty?): aborting instead of "
                             "looping forever")
        epoch += 1

    if options.finetune_step > 0:
        if options.ignore_mt_mass:
            mt_batcher = None
        trainer.reset_for_finetune()
        lang_directions = MTTrainer.lang_directions(bt_langs, tp)
        print("lang dirs", lang_directions)
        fepoch = 0
        # The back-translation phase holds a decode and a train step per
        # batch: its budgets are divided by max(2, --bt-beam).
        if mass_batcher is not None:
            denom = max(2, options.bt_beam_width)
            mass_batcher = build_mass_batcher(
                options.batch // denom, options.total_capacity // denom)
        while step < options.finetune_step + options.step:
            print(f"finetune epoch {fepoch}")
            step_before = step
            step = trainer.train_epoch(
                step, options.model_path, mt_batcher=mt_batcher,
                mass_batcher=mass_batcher, dev_batcher=dev_batcher,
                img_batcher=img_batcher, image_root=options.image_dir,
                max_step=options.finetune_step + options.step,
                fine_tune=True, lang_directions=lang_directions,
                eval_every=options.eval_every, save_every=options.save_every,
                epoch_seed=1000 + fepoch)
            if step == step_before:
                raise SystemExit("a fine-tune epoch produced zero train "
                                 "steps: aborting instead of looping "
                                 "forever")
            fepoch += 1

    if trainer.chief:
        print("Finished Training!")
    leave(joined)


if __name__ == "__main__":
    main()
