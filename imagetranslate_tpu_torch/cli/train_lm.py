"""MLM training CLI (port of imagetranslate_tpu/cli/train_lm.py): the same
flags and defaults, plus ``--device``.

    python -m imagetranslate_tpu_torch.cli.train_lm --tok TOKDIR --model OUT \
        --train BLOCKDIR [--dev DEVBLOCKDIR] --step N [--reformer --size 1..3] \
        [--device cuda]

``--train`` / ``--dev`` are directories written by ``cli.create_batches``.
``--reformer`` selects the long-document LM with local block attention at
4096 positions. ``--pretrained`` starts from an LM checkpoint (its weights;
the model is built from the flags, as in the JAX CLI). Checkpoints are the
JAX package's directory layout.

``--mesh DxM`` under torchrun, one process a rank (D x M ranks): the BERT LM
splits its heads, FFN and word table over the model axis and the rows over
the data axis; the long-document LM (``--reformer``) splits the SEQUENCE
over the model axis (context parallelism) and the rows over the data axis.
The data axis must divide ``--batch``. Rank 0 logs and writes:

    torchrun --nproc-per-node 4 -m imagetranslate_tpu_torch.cli.train_lm \
        --mesh 2x2 --tok TOKDIR --model OUT --train BLOCKDIR ...
    torchrun --nproc-per-node 4 -m imagetranslate_tpu_torch.cli.train_lm \
        --reformer --mesh 1x4 ...

Several machines: ``torchrun --nnodes 2 --node-rank i --master-addr HOST
--master-port PORT --nproc-per-node N`` on each.
"""

from __future__ import annotations

import argparse
import os


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_lm")
    p.add_argument("--train", dest="train_path", required=True)
    p.add_argument("--dev", dest="dev_path", default=None)
    p.add_argument("--tok", dest="tokenizer_path", required=True)
    p.add_argument("--cache_size", type=int, default=300)
    p.add_argument("--model", dest="model_path", required=True)
    p.add_argument("--pretrained", dest="pretrained_path", default=None)
    p.add_argument("--epoch", dest="num_epochs", type=int, default=100)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--batch", type=int, default=16,
                   help="rows per MLM batch (each row is a full block)")
    p.add_argument("--mask", dest="mask_prob", type=float, default=0.15)
    p.add_argument("--lr", dest="learning_rate", type=float, default=0.0001)
    p.add_argument("--warmup", type=int, default=12500)
    p.add_argument("--step", type=int, default=125000)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--enc", dest="encoder_layer", type=int, default=6)
    p.add_argument("--embed", dest="embed_dim", type=int, default=768)
    p.add_argument("--intermediate", dest="intermediate_layer_dim", type=int,
                   default=3072)
    p.add_argument("--reformer", action="store_true", default=False)
    p.add_argument("--size", dest="model_size", type=int, default=2,
                   help="reformer preset 1..3")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--mesh", dest="mesh_spec", default="",
                   help="device mesh DxM (under torchrun)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")
    return p


def main(argv=None):
    options = get_parser().parse_args(argv)

    from imagetranslate_tpu_torch.data.loader import DocBlockDataset
    from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train.checkpoint import load_checkpoint

    from imagetranslate_tpu_torch.parallel.mesh import cli_mesh, leave

    mesh, joined = cli_mesh(options.mesh_spec, options.device)
    if mesh is not None and options.batch % mesh.n_data:
        raise SystemExit(f"--batch {options.batch}: the mesh's data axis "
                         f"({mesh.n_data}) must divide it")
    tp = TextProcessor(options.tokenizer_path)

    if options.reformer:
        from imagetranslate_tpu_torch.train.trainer_longdoc import (
            LongDocTrainer,
        )

        trainer = LongDocTrainer.from_options(options, tp, mesh=mesh,
                                              device=options.device)
    else:
        from imagetranslate_tpu_torch.train.trainer_lm import LMTrainer

        cfg = Seq2SeqConfig(
            vocab_size=tp.vocab_size(),
            num_languages=max(1, len(tp.languages)),
            hidden_size=options.embed_dim,
            intermediate_size=options.intermediate_layer_dim,
            enc_layers=options.encoder_layer,
            dropout=options.dropout,
            attention_dropout=options.dropout,
            dtype=options.dtype,
        )
        if cfg.hidden_size % cfg.num_heads:
            raise SystemExit(
                f"--embed {cfg.hidden_size} is not a multiple of the model's "
                f"{cfg.num_heads} attention heads (the CLI has no heads "
                f"flag): pick a multiple of {cfg.num_heads}")
        trainer = LMTrainer(cfg, tp, lr=options.learning_rate,
                            warmup=options.warmup, clip=options.clip,
                            mask_prob=options.mask_prob, mesh=mesh,
                            device=options.device)

    def say(line):
        if trainer.chief:
            print(line, flush=True)

    if options.pretrained_path:
        params, _, meta = load_checkpoint(options.pretrained_path)
        trainer.set_reference_params(params)
        say(f"Restored pretrained LM (step {meta.get('step', 0)})")

    train_data = DocBlockDataset(options.train_path,
                                 max_cache_size=options.cache_size)
    dev_data = None
    if options.dev_path:
        dev_data = DocBlockDataset(options.dev_path,
                                   max_cache_size=options.cache_size,
                                   load_all=True)

    os.makedirs(options.model_path, exist_ok=True)
    step, epoch = 0, 1
    while step < options.step and epoch <= options.num_epochs:
        say(f"train epoch {epoch}")
        step = trainer.train_epoch(step, options.model_path, train_data,
                                   dev_data, options.batch, options.step)
        epoch += 1
    say("Finished Training!")
    leave(joined)


if __name__ == "__main__":
    main()
