"""Document-level LM binarizer CLI (port of
imagetranslate_tpu/cli/create_batches.py): fixed ``--seq_len`` blindly split
rows in ``N.pkl`` blocks plus an ``info.txt`` header, the input of
``cli.train_lm``.

    python -m imagetranslate_tpu_torch.cli.create_batches --data docs.txt \
        --cache BLOCKDIR --tok TOKDIR [--seq_len 512] [--block 10000] \
        [--packed]

``--packed`` writes each block as ITR1 records (``data/recordio.py``).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser("create_batches")
    p.add_argument("--data", dest="data_path", required=True)
    p.add_argument("--cache", dest="cache_path", required=True)
    p.add_argument("--tok", dest="tokenizer_path", required=True)
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--block", dest="sen_block_size", type=int, default=10000)
    p.add_argument("--packed", action="store_true",
                   help="write ITR1 records (data/recordio.py) instead of "
                        "marshal")
    options = p.parse_args(argv)

    from imagetranslate_tpu_torch.data.binarize import write_doc_blocks
    from imagetranslate_tpu_torch.text.processor import TextProcessor

    tp = TextProcessor(options.tokenizer_path)
    n = write_doc_blocks(tp, options.data_path, options.cache_path,
                         seq_len=options.seq_len,
                         sen_block_size=options.sen_block_size,
                         packed=options.packed)
    print(f"Wrote {n} blocks")


if __name__ == "__main__":
    main()
