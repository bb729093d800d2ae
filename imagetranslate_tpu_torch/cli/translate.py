"""Batch translation CLI (port of imagetranslate_tpu/cli/translate.py): the
same flags and defaults, the same output (one translation per input line, in
input order; ``--verbose`` writes "output ||| input"), plus ``--device``.

Usage:
    python -m imagetranslate_tpu_torch.cli.translate --tok TOKDIR \
        --model CKPTDIR --input in.txt --output out.txt --src en --target fa \
        [--verbose] [--device cuda]

The checkpoint is the JAX package's directory layout (train/checkpoint.py),
so a model trained by either package translates here.

Data-parallel decode: ``--dp N`` under torchrun (one process a rank, N
ranks). Rank r decodes the batches r, r + N, r + 2N, ... whole, so each
batch is decoded exactly as ``--dp 0`` decodes it; the decoded lines travel
to rank 0 as pickled strings over the process group (host memory), and rank
0 writes them in the order ``--dp 0`` does:

    torchrun --nproc-per-node 2 -m imagetranslate_tpu_torch.cli.translate \
        --dp 2 --tok TOKDIR --model CKPTDIR --input in.txt --output out.txt \
        --src en --target fa
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("translate")
    p.add_argument("--input", dest="input_path", default=None)
    p.add_argument("--src", dest="src_lang", default=None)
    p.add_argument("--target", dest="target_lang", default=None)
    p.add_argument("--output", dest="output_path", default=None)
    p.add_argument("--batch", dest="batch", type=int, default=4000)
    p.add_argument("--tok", dest="tokenizer_path", default=None)
    p.add_argument("--model", dest="model_path", default=None)
    p.add_argument("--verbose", action="store_true", default=False)
    p.add_argument("--beam", dest="beam_width", type=int, default=4)
    p.add_argument("--max_len_a", type=float, default=1.3)
    p.add_argument("--max_len_b", type=int, default=5)
    p.add_argument("--len-penalty", dest="len_penalty_ratio", type=float,
                   default=0.8)
    p.add_argument("--capacity", dest="total_capacity", type=int, default=600)
    p.add_argument("--clean-ties", dest="clean_ties", action="store_true",
                   default=False,
                   help="use the clean beam tie/limit semantics instead of "
                        "reproducing the reference decoder's quirks")
    p.add_argument("--dict", dest="dict_path", default=None,
                   help="lexical proposal dictionary")
    p.add_argument("--bucket_step", type=int, default=16,
                   help="length bucket multiple")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel decode over N ranks launched by "
                        "torchrun (0 or 1: one process)")
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (cuda, cuda:N or cpu)")
    return p


def build_model(options, device=None):
    from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train.checkpoint import (
        load_config,
        load_params,
    )
    from imagetranslate_tpu_torch.train.weights import state_dict_from_flax

    tp = TextProcessor(options.tokenizer_path)
    cfg = load_config(options.model_path)
    device = torch.device(options.device if device is None else device)
    model = Seq2Seq(cfg, device=device)
    sd = state_dict_from_flax(load_params(options.model_path), cfg)
    model.load_state_dict(sd, strict=True)
    model.eval()
    return model, cfg, tp


def build_batches(options, tp):
    from imagetranslate_tpu_torch.data.loader import MTBatcher, get_lex_dict

    lex_dict = None
    if getattr(options, "dict_path", None):
        lex_dict = get_lex_dict(options.dict_path)

    src_lang_tok = f"<{options.src_lang}>"
    dst_lang_tok = f"<{options.target_lang}>"
    src_lang_type = tp.languages[src_lang_tok]
    dst_lang_type = tp.languages[dst_lang_tok]
    fixed_output = [tp.token_id(dst_lang_tok)]
    examples = []
    with open(options.input_path) as s_fp:
        for src_line in s_fp:
            if not src_line.strip():
                continue
            line = " ".join([src_lang_tok, src_line.strip(), "</s>"])
            ids = tp.tokenize_one_sentence(line)
            examples.append((ids, fixed_output, src_lang_type, dst_lang_type))
    return MTBatcher(examples, pad_id=tp.pad_token_id(),
                     max_batch=options.batch,
                     capacity_mb=options.total_capacity, max_seq_len=10000,
                     bucket_step=getattr(options, "bucket_step", 16),
                     lex_dict=lex_dict)


def _pad_rows(arr, rows):
    """Pad the leading dim up to `rows` with zeros (np arrays only)."""
    if arr is None or arr.shape[0] == rows:
        return arr
    pad = [(0, rows - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def translate_batches(model, cfg, tp, batcher, options, writer=sys.stdout,
                      rank: int = 0, world: int = 1):
    """Decode ``batcher`` and write one line per input line. ``rank`` of
    ``world`` (``--dp``): decode the batches i with i % world == rank and
    gather the lines on rank 0, the one that writes."""
    from imagetranslate_tpu_torch.data.prefetch import PrefetchIterator
    from imagetranslate_tpu_torch.decoding.beam import (
        beam_search,
        max_len_for,
        trim_outputs,
    )

    device = next(model.parameters()).device

    def dev(x):
        return None if x is None else torch.as_tensor(x).to(device)

    def stage(b):
        # Rows pad up to a power of two (>= 8) exactly as the JAX CLI pads
        # them: padded rows (src_size 0) freeze within a few steps, and
        # keeping them keeps the loop's early exit, and so the output, the
        # same as the JAX decode's.
        rows = max(8, 1 << (int(b.src.shape[0]) - 1).bit_length())
        s = {
            "src": dev(_pad_rows(b.src, rows)),
            "src_mask": dev(_pad_rows(b.src_mask, rows)),
            "src_langs": dev(_pad_rows(b.src_langs, rows)),
            "first": dev(_pad_rows(b.dst[:, 0], rows)),
            "dst_langs": dev(_pad_rows(b.dst_langs, rows)),
            "src_sizes": dev(_pad_rows(b.src_sizes, rows)),
            "props": dev(_pad_rows(b.proposals, rows)),
            "pmask": dev(_pad_rows(b.proposal_mask, rows)),
        }
        return b, int(b.row_mask.sum()), s

    sen_count = 0
    decoded = []    # (batch index, its lines) under --dp

    def flush(item):
        # Detokenize + write the previous batch while the device decodes
        # the current one.
        nonlocal sen_count
        index, b, n_real, best, lengths = item
        outs = trim_outputs(best, lengths, remove_first_token=True)
        lines = []
        for i in range(n_real):
            hyp = tp.decode(outs[i])
            if options.verbose:
                src_ids = [t for t in b.src[i].tolist()
                           if t != tp.pad_token_id()][1:]
                if src_ids and src_ids[-1] == tp.sep_token_id():
                    src_ids = src_ids[:-1]
                lines.append(hyp + " ||| " + tp.decode(src_ids))
            else:
                lines.append(hyp)
        if world > 1:
            decoded.append((index, lines))
        else:
            writer.write("\n".join(lines) + "\n")
        sen_count += n_real
        print(f"Translated {sen_count} sentences", end="\r", file=sys.stderr)

    pending = None
    mine = ((i, b) for i, b in enumerate(batcher) if i % world == rank)
    with torch.no_grad(), PrefetchIterator(
            mine, lambda item: (item[0], *stage(item[1])),
            depth=2) as staged:
        for index, b, n_real, s in staged:
            enc = model.encode(s["src"], s["src_mask"], s["src_langs"])
            L = max_len_for(s["src"].shape[1], options.max_len_a,
                            options.max_len_b, cfg.max_position_embeddings)
            L = min(-(-L // 16) * 16, cfg.max_position_embeddings)
            best, lengths = beam_search(
                model, enc, s["src_mask"], s["first"], s["dst_langs"],
                s["src_sizes"], s["props"], s["pmask"],
                beam_width=options.beam_width,
                max_len=L, max_len_a=options.max_len_a,
                max_len_b=options.max_len_b,
                len_penalty_ratio=options.len_penalty_ratio,
                pad_id=tp.pad_token_id(), eos_id=tp.sep_token_id(),
                ref_ties=not getattr(options, "clean_ties", False))
            if pending is not None:
                flush(pending)
            pending = (index, b, n_real, best, lengths)
    if pending is not None:
        flush(pending)
    if world > 1:
        import torch.distributed as dist

        parts = [None] * world if rank == 0 else None
        dist.gather_object(decoded, parts, dst=0)
        if rank == 0:
            for _, lines in sorted(p for part in parts for p in part):
                writer.write("\n".join(lines) + "\n")
    print(f"\nTranslated {sen_count} sentences", file=sys.stderr)


def main(argv=None):
    import contextlib

    options = get_parser().parse_args(argv)
    rank, world, device = 0, 1, None
    if options.dp > 1:
        import torch.distributed as dist

        from imagetranslate_tpu_torch.parallel.mesh import (
            init_distributed,
            rank_device,
        )

        if not init_distributed(device=options.device) \
                or dist.get_world_size() != options.dp:
            raise SystemExit(f"--dp {options.dp} runs one process a rank: "
                             f"launch with torchrun --nproc-per-node "
                             f"{options.dp}")
        rank, world = dist.get_rank(), options.dp
        device = rank_device(options.device)
    try:
        model, cfg, tp = build_model(options, device)
        batcher = build_batches(options, tp)
        with (open(options.output_path, "w") if rank == 0
              else contextlib.nullcontext()) as writer:
            translate_batches(model, cfg, tp, batcher, options, writer,
                              rank, world)
    finally:
        if world > 1:
            dist.destroy_process_group()
    print("Done!", file=sys.stderr)


if __name__ == "__main__":
    main()
