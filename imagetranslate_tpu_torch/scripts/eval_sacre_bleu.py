"""Cased / intl-tokenized / lowercased corpus BLEU (reference
scripts/eval_sacre_bleu.py). --output hyp file, --gold ref[,ref2...]"""
import argparse

import sacrebleu

def main():
    p = argparse.ArgumentParser()
    p.add_argument("--output", required=True)
    p.add_argument("--gold", required=True)
    a = p.parse_args()
    output = open(a.output).read().strip().split("\n")
    gold = [open(g).read().strip().split("\n")
            for g in a.gold.strip().split(",")]
    print("Cased Detokenized BLEU")
    b = sacrebleu.corpus_bleu(output, gold)
    print(b); print(b.score)
    print("Cased BLEU")
    b = sacrebleu.corpus_bleu(output, gold, tokenize="intl")
    print(b); print(b.score)
    print("Lowercased BLEU")
    b = sacrebleu.corpus_bleu(output, gold, lowercase=True, tokenize="intl")
    print(b); print(b.score)

if __name__ == "__main__":
    main()
