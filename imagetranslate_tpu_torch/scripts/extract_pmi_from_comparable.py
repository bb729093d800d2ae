"""PMI-style word-pair scores over comparable "src ||| dst" pairs: count
co-occurrences and per-side frequencies, emit log(p(s,t)/(p(s)p(t)))-ranked
candidates (reference scripts/extract_pmi_from_comparable.py behavior).
argv: pairs output min_count"""
import math
import sys
from collections import Counter

def main():
    min_count = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    cooc = Counter()
    src_c = Counter()
    dst_c = Counter()
    total = 0
    with open(sys.argv[1]) as r:
        for line in r:
            spl = line.strip().split(" ||| ")
            if len(spl) < 2:
                continue
            sw = set(spl[0].lower().split(" "))
            dw = set(spl[1].lower().split(" "))
            for s in sw:
                src_c[s] += 1
                for d in dw:
                    cooc[(s, d)] += 1
            for d in dw:
                dst_c[d] += 1
            total += 1
    with open(sys.argv[2], "w") as w:
        for (s, d), c in cooc.most_common():
            if c < min_count:
                break
            pmi = math.log(c * total / (src_c[s] * dst_c[d]))
            w.write(s + "\t" + d + "\t" + str(round(pmi, 4)) + "\t"
                    + str(c) + "\n")
    print("Done!")

if __name__ == "__main__":
    main()
