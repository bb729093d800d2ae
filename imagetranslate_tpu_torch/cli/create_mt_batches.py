"""Binarizer CLI (port of imagetranslate_tpu/cli/create_mt_batches.py):
parallel text (``--dst``) -> one ``.mt`` file; monolingual text -> MASS
shards ``OUTPUT.N``, the inputs of ``cli.train_mt``'s ``--train_mt`` and
``--mass_train``.

    python -m imagetranslate_tpu_torch.cli.create_mt_batches --tok TOKDIR \
        --src src.txt --src-lang en [--dst dst.txt --dst-lang fa] \
        --output train.mt

``--packed`` (the packed record format) stops the run with a message.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser("create_mt_batches")
    p.add_argument("--src", dest="src_data_path", required=True)
    p.add_argument("--dst", dest="dst_data_path", default=None)
    p.add_argument("--output", dest="output_path", required=True)
    p.add_argument("--tok", dest="tokenizer_path", required=True)
    p.add_argument("--max_seq_len", type=int, default=175)
    p.add_argument("--min_seq_len", type=int, default=1)
    p.add_argument("--src-lang", dest="src_lang", required=True)
    p.add_argument("--dst-lang", dest="dst_lang", default=None)
    p.add_argument("--packed", action="store_true",
                   help="the packed record format (not ported yet)")
    options = p.parse_args(argv)
    if options.packed:
        raise SystemExit("--packed is not ported yet (the packed record "
                         "format: ROADMAP module 15)")

    from imagetranslate_tpu_torch.data.binarize import write_mt
    from imagetranslate_tpu_torch.text.processor import TextProcessor

    tp = TextProcessor(options.tokenizer_path)
    src_lang = tp.token_id(f"<{options.src_lang}>")
    dst_lang = (tp.token_id(f"<{options.dst_lang}>")
                if options.dst_lang is not None else None)
    n = write_mt(tp, options.output_path, options.src_data_path, src_lang,
                 options.dst_data_path, dst_lang,
                 min_len=options.min_seq_len, max_len=options.max_seq_len)
    print(f"Wrote {n} examples")


if __name__ == "__main__":
    main()
