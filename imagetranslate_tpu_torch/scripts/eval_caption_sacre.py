"""Multi-reference caption BLEU keyed on image file name (reference
scripts/eval_caption_sacre.py). argv: ref_tsv hyp_tsv  (both
"path\tcaption"; paths keyed by basename)."""
import sys
from collections import defaultdict

import sacrebleu

def main():
    refs = defaultdict(list)
    max_ref = 0
    with open(sys.argv[1]) as r:
        for line in r:
            spl = line.strip().split("\t")
            if len(spl) < 2:
                continue
            key = spl[0].strip().rsplit("/", 1)[-1]
            refs[key].append(spl[1].strip())
            max_ref = max(max_ref, len(refs[key]))
    outputs = []
    references = [[] for _ in range(max_ref)]
    with open(sys.argv[2]) as r:
        for line in r:
            spl = line.strip().split("\t")
            if len(spl) < 2:
                continue
            key = spl[0].strip().rsplit("/", 1)[-1]
            vals = refs[key]
            for i in range(max_ref):
                references[i].append(vals[i] if i < len(vals) else None)
            outputs.append(spl[1].strip())
    b = sacrebleu.corpus_bleu(outputs, references, lowercase=True,
                              tokenize="intl")
    print(b)
    print(b.score)

if __name__ == "__main__":
    main()
