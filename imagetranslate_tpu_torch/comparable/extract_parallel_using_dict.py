"""Dictionary-overlap mutual-best parallel extraction (reference
comparable/extract_parallel_using_dict.py). argv: dict pairs pairs_tok output"""
import sys
from collections import defaultdict

def overlap(s1, s2, d):
    ws1, ws2 = s1.strip().split(" "), s2.strip().split(" ")
    found = sum(1 for w1 in ws1 for w2 in ws2 if w2 in d[w1] or w1 == w2)
    return found / min(len(ws1), len(ws2))

def main():
    d = defaultdict(set)
    with open(sys.argv[1]) as r:
        for line in r:
            spl = line.strip().split("\t")
            if len(spl) >= 2:
                d[spl[0]].add(spl[1])
                d[spl[0]].add(spl[1].lower())

    best_s2d, best_d2s = {}, {}
    with open(sys.argv[2]) as raw_r, open(sys.argv[3]) as tok_r:
        for raw, tok in zip(raw_r, tok_r):
            sen = raw.strip().split(" ||| ")
            spl = tok.strip().split(" ||| ")
            if len(sen) < 2 or len(spl) < 2:
                continue
            s = overlap(spl[0].lower(), spl[1].lower(), d)
            if s <= 0.3:
                continue
            if sen[0] not in best_s2d or best_s2d[sen[0]][1] < s:
                best_s2d[sen[0]] = (sen[1], s)
            if sen[1] not in best_d2s or best_d2s[sen[1]][1] < s:
                best_d2s[sen[1]] = (sen[0], s)

    wrote = 0
    with open(sys.argv[4], "w") as w:
        for src, (dst, s) in best_s2d.items():
            if best_d2s[dst][0] == src:
                w.write(src + " ||| " + dst + "\t" + str(s) + "\n")
                wrote += 1
    print("Done!", wrote)

if __name__ == "__main__":
    main()
