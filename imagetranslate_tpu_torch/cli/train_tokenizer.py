"""Tokenizer-training CLI (port of imagetranslate_tpu/cli/train_tokenizer.py).

Input lines look like "<en> sentence </s> another sentence </s>": the
language tags are collected into the language map (sorted order -> type
ids) and the stripped sentences feed BPE training.

    python -m imagetranslate_tpu_torch.cli.train_tokenizer --data all.txt \
        --vocab_size 30000 --model TOKDIR
"""

from __future__ import annotations

import argparse
import os

from imagetranslate_tpu_torch.text.processor import TextProcessor


def get_tokenizer(train_path: str, model_path: str,
                  vocab_size: int) -> TextProcessor:
    os.makedirs(model_path, exist_ok=True)
    tp = TextProcessor()
    languages = set()
    tmp = train_path + ".tmp"
    with open(tmp, "w") as wf, open(train_path) as rf:
        for line in rf:
            spl = [sen.strip() for sen in line.split("</s>") if sen.strip()]
            if not spl:
                continue
            if spl[0].startswith("<"):
                sen_split = spl[0].strip().split(" ")
                spl[0] = " ".join(sen_split[1:])
                languages.add(sen_split[0])
            wf.write("\n".join(spl) + "\n")
    print(" ".join(sorted(languages)))
    tp.train_tokenizer(paths=[tmp], vocab_size=vocab_size,
                       to_save_dir=model_path,
                       languages={lang: i for i, lang in
                                  enumerate(sorted(languages))})
    os.remove(tmp)
    return tp


def main(argv=None):
    p = argparse.ArgumentParser("train_tokenizer")
    p.add_argument("--data", dest="data_path", required=True)
    p.add_argument("--vocab_size", type=int, default=30000)
    p.add_argument("--model", dest="model_path", required=True)
    options = p.parse_args(argv)
    get_tokenizer(options.data_path, options.model_path, options.vocab_size)
    print("done!")


if __name__ == "__main__":
    main()
