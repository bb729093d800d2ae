"""COCO annotation JSON -> caption binary (port of
imagetranslate_tpu/cli/binarize_coco_data.py, the same flags).

    python -m imagetranslate_tpu_torch.cli.binarize_coco_data \
        --file captions_train2017.json --output coco.bin --tok TOKDIR
"""

from __future__ import annotations

import argparse

from imagetranslate_tpu_torch.cli.binarize_captions_from_list import (
    PACKED_REFUSAL,
)


def main(argv=None):
    p = argparse.ArgumentParser("binarize_coco_data")
    p.add_argument("--file", required=True)
    p.add_argument("--output", dest="output_file", required=True)
    p.add_argument("--tok", dest="tokenizer_path", required=True)
    p.add_argument("--max-len", dest="max_len", type=int, default=256)
    p.add_argument("--sample", dest="sample_size", type=int, default=-1)
    p.add_argument("--packed", action="store_true",
                   help="the packed record format (not ported yet)")
    options = p.parse_args(argv)
    if options.packed:
        raise SystemExit(PACKED_REFUSAL)

    from imagetranslate_tpu_torch.data.binarize_captions import (
        write_from_coco,
    )
    from imagetranslate_tpu_torch.text.processor import TextProcessor

    tp = TextProcessor(options.tokenizer_path)
    write_from_coco(tp, options.output_file, options.file,
                    max_len=options.max_len, sample_size=options.sample_size)
    print("Finished")


if __name__ == "__main__":
    main()
