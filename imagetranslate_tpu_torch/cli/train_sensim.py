"""SenSim training CLI (port of imagetranslate_tpu/cli/train_sensim.py): the
same flags and defaults, plus ``--device``.

    python -m imagetranslate_tpu_torch.cli.train_sensim --tok TOKDIR \
        --model OUT --train_mt pairs.mt [--dev_mt dev.mt] \
        --src-neg SRC_PREFIX --dst-neg DST_PREFIX --step N [--device cuda]

Parallel ``.mt`` pairs train the InfoNCE objective against negative pools
drawn from monolingual MASS shards (``--src-neg``/``--dst-neg``, the
prefixes ``data.binarize.write_mt`` writes without a target file).
``--pretrained`` starts from a SenSim checkpoint. Checkpoints are the JAX
package's layout, so ``cli.get_sen_sim`` of either package scores with what
this one trained. A non-empty ``--mesh`` (ROADMAP module 14) stops the run
with a message.
"""

from __future__ import annotations

import argparse
import os


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_sensim")
    p.add_argument("--tok", dest="tokenizer_path", required=True)
    p.add_argument("--model", dest="model_path", required=True)
    p.add_argument("--pretrained", dest="pretrained_path", default=None)
    p.add_argument("--train_mt", dest="mt_train_path", required=True)
    p.add_argument("--dev_mt", dest="mt_dev_path", default=None)
    p.add_argument("--src-neg", dest="src_neg", required=True)
    p.add_argument("--dst-neg", dest="dst_neg", required=True)
    p.add_argument("--step", type=int, default=125000)
    p.add_argument("--batch", type=int, default=20000)
    p.add_argument("--capacity", dest="total_capacity", type=int, default=600)
    p.add_argument("--max_seq_len", type=int, default=175)
    add_encoder_flags(p)
    return p


def add_encoder_flags(p: argparse.ArgumentParser):
    """The optimizer and text-encoder flags of the SenSim and Caption2Image
    CLIs, and ``--device``."""
    p.add_argument("--lr", dest="learning_rate", type=float, default=0.0001)
    p.add_argument("--warmup", type=int, default=12500)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--enc", dest="encoder_layer", type=int, default=6)
    p.add_argument("--embed", dest="embed_dim", type=int, default=768)
    p.add_argument("--intermediate", dest="intermediate_layer_dim", type=int,
                   default=3072)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--mesh", dest="mesh_spec", default="",
                   help="device mesh (not ported yet: one device)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")


def encoder_config(options, tp):
    """The text encoder's config from the flags, as the JAX CLIs build it;
    ``--mesh`` and an ``--embed`` the head count does not divide stop the
    run."""
    from imagetranslate_tpu_torch.models.config import Seq2SeqConfig

    if options.mesh_spec:
        raise SystemExit("--mesh is not ported yet (multi-device training: "
                         "ROADMAP module 14)")
    if tp.pad_token_id() != 0:
        raise SystemExit("the tokenizer's <pad> must have id 0")
    cfg = Seq2SeqConfig(
        vocab_size=tp.vocab_size(),
        num_languages=max(1, len(tp.languages)),
        hidden_size=options.embed_dim,
        intermediate_size=options.intermediate_layer_dim,
        enc_layers=options.encoder_layer,
        dropout=options.dropout, attention_dropout=options.dropout,
        dtype=options.dtype)
    if cfg.hidden_size % cfg.num_heads:
        raise SystemExit(
            f"--embed {cfg.hidden_size} is not a multiple of the model's "
            f"{cfg.num_heads} attention heads (the CLI has no heads flag): "
            f"pick a multiple of {cfg.num_heads}")
    return cfg


def load_pretrained(trainer, path: str):
    """Start ``trainer`` from the weights of the checkpoint at ``path``,
    which must hold every weight of its model (extra ones are ignored)."""
    from imagetranslate_tpu_torch.train.checkpoint import load_params

    try:
        trainer.set_reference_params(load_params(path))
    except KeyError as e:
        raise SystemExit(f"--pretrained {path}: the checkpoint lacks "
                         f"{e} of this model") from None


def main(argv=None):
    options = get_parser().parse_args(argv)

    from imagetranslate_tpu_torch.data.binarize import load_mass, load_mt
    from imagetranslate_tpu_torch.data.loader import MassBatcher, MTBatcher
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train.trainer_sensim import SenSimTrainer

    tp = TextProcessor(options.tokenizer_path)
    cfg = encoder_config(options, tp)
    trainer = SenSimTrainer(cfg, tp, lr=options.learning_rate,
                            warmup=options.warmup, clip=options.clip,
                            device=options.device)
    if options.pretrained_path:
        load_pretrained(trainer, options.pretrained_path)

    pad = tp.pad_token_id()
    mt_batcher = MTBatcher(load_mt(options.mt_train_path), pad_id=pad,
                           max_batch=options.batch // 2,
                           capacity_mb=options.total_capacity // 2,
                           max_seq_len=options.max_seq_len)
    src_neg, dst_neg = (
        MassBatcher(load_mass(prefix), pad_id=pad,
                    max_batch=options.batch * 5,
                    capacity_mb=options.total_capacity * 5,
                    max_seq_len=options.max_seq_len)
        for prefix in (options.src_neg, options.dst_neg))
    dev_batcher = None
    if options.mt_dev_path:
        dev_batcher = MTBatcher(load_mt(options.mt_dev_path), pad_id=pad,
                                max_batch=options.batch // 10,
                                capacity_mb=options.total_capacity)

    os.makedirs(options.model_path, exist_ok=True)
    step, epoch = 0, 0
    while step < options.step:
        print(f"train epoch {epoch}")
        step = trainer.train_epoch(step, options.model_path, mt_batcher,
                                   src_neg, dst_neg, dev_batcher,
                                   max_step=options.step, epoch_seed=epoch)
        epoch += 1
    print("Finished Training!")


if __name__ == "__main__":
    main()
