"""Tokenize a text file a line at a time into token ids, or with ``--txt``
into subword pieces (port of imagetranslate_tpu/cli/tokenize_file.py; the
input of word aligners such as fast_align).

Each non-empty line goes through ``tokenize_one_line(line,
ignore_middle_eos=True)``: a leading ``<lang>`` tag kept, inner ``</s>``
dropped, one final ``</s>``. ``--txt`` writes the pieces without the first
and last token (the language and ``</s>``), ``<unk>`` as ``unk``.

    python -m imagetranslate_tpu_torch.cli.tokenize_file --tok TOKDIR \
        --input in.txt --output out.txt [--txt]
"""

from __future__ import annotations

import argparse


def write(tp, output_file: str, txt_file: str, output_txt: bool = False):
    with open(txt_file) as fp, open(output_file, "w") as writer:
        for line in fp:
            if len(line.strip()) == 0:
                continue
            tok_line = tp.tokenize_one_line(line.strip(),
                                            ignore_middle_eos=True)
            if output_txt:
                pieces = [tp.id2token(tok) for tok in tok_line][1:-1]
                pieces = [tok if tok != "<unk>" else "unk" for tok in pieces]
            else:
                pieces = [str(tok) for tok in tok_line]
            writer.write(" ".join(pieces) + "\n")


def main(argv=None):
    p = argparse.ArgumentParser("tokenize_file")
    p.add_argument("--tok", dest="tokenizer_path", required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--txt", dest="output_text", action="store_true",
                   help="write subword text instead of token ids")
    options = p.parse_args(argv)

    from imagetranslate_tpu_torch.text.processor import TextProcessor

    tp = TextProcessor(options.tokenizer_path)
    write(tp, options.output, options.input, output_txt=options.output_text)


if __name__ == "__main__":
    main()
