"""Wiki-document JSON ({content, images: [{img_path, caption}]}) -> caption
binary, with the three ways of picking an image's captions (port of
imagetranslate_tpu/cli/binarize_image_caption_data.py, the same flags).

    python -m imagetranslate_tpu_torch.cli.binarize_image_caption_data \
        --file docs.json --output wiki.bin --tok TOKDIR [--image IMGDIR]
"""

from __future__ import annotations

import argparse

from imagetranslate_tpu_torch.cli.binarize_captions_from_list import (
    PACKED_REFUSAL,
)


def main(argv=None):
    p = argparse.ArgumentParser("binarize_image_caption_data")
    p.add_argument("--file", required=True)
    p.add_argument("--output", dest="output_file", required=True)
    p.add_argument("--tok", dest="tokenizer_path", required=True)
    p.add_argument("--max-len", dest="max_len", type=int, default=256)
    p.add_argument("--only-captions", action="store_true")
    p.add_argument("--packed", action="store_true",
                   help="the packed record format (not ported yet)")
    p.add_argument("--all-sentences", action="store_true",
                   help="use every long sentence, not just relevant ones")
    p.add_argument("--image", dest="image_dir", default=None,
                   help="root image dir; when given, probe that each image "
                        "opens")
    p.add_argument("--skip-check", action="store_true",
                   help="skip the image-openability probe")
    p.add_argument("--ref", dest="ref_file", default=None,
                   help="wiki-doc JSON; keep only docs sharing an img_path "
                        "with it")
    options = p.parse_args(argv)
    if options.packed:
        raise SystemExit(PACKED_REFUSAL)

    from imagetranslate_tpu_torch.data.binarize_captions import (
        write_from_wiki_json,
    )
    from imagetranslate_tpu_torch.text.processor import TextProcessor

    tp = TextProcessor(options.tokenizer_path)
    write_from_wiki_json(tp, options.output_file, options.file,
                         max_len=options.max_len,
                         only_captions=options.only_captions,
                         choose_relevant=not options.all_sentences,
                         root_img_dir=options.image_dir,
                         skip_check=(options.skip_check
                                     or options.image_dir is None),
                         ref_file=options.ref_file)
    print("Finished")


if __name__ == "__main__":
    main()
