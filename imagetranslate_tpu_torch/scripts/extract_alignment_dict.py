"""Mutual-best word-translation dict from fast_align output: count aligned
co-occurrences, keep pairs that are each other's argmax, plus a capitalized
variant (reference scripts/extract_alignment_dict.py).
argv: fastalign_pairs alignments out_dict"""
import sys
from collections import Counter

def main():
    coocs = Counter()
    with open(sys.argv[1]) as dr, open(sys.argv[2]) as ar:
        for src2dst, alignment in zip(dr, ar):
            try:
                src, dst = src2dst.strip().split(" ||| ")
            except ValueError:
                continue
            sw, dw = src.split(" "), dst.split(" ")
            # A single out-of-range/malformed index drops the WHOLE line's
            # alignments — the reference materializes the line's pair list
            # inside one try (extract_alignment_dict.py:19-23), so a
            # mid-line failure discards even its valid earlier entries.
            try:
                line_pairs = [(sw[int(p[0])], dw[int(p[1])])
                              for p in (a.split("-")
                                        for a in alignment.strip().split(" "))
                              if len(p) == 2]
            except (ValueError, IndexError):
                continue
            for sp, dp in line_pairs:
                coocs[(sp, dp)] += 1

    s2d, d2s = {}, {}
    for (s, d), c in coocs.items():
        if s not in s2d or s2d[s][1] < c:
            s2d[s] = (d, c)
        if d not in d2s or d2s[d][1] < c:
            d2s[d] = (s, c)

    written = 0
    with open(sys.argv[3], "w") as w:
        for s, (d, _) in s2d.items():
            if d2s[d][0] != s or s.lower().strip() == d.lower().strip():
                continue
            pair = s + " ||| " + d
            w.write(pair + "\n")
            written += 1
            if s and d:
                upper = s[0].upper() + s[1:] + " ||| " + d[0].upper() + d[1:]
                if upper != pair:
                    w.write(upper + "\n")
                    written += 1
    print("written", written)

if __name__ == "__main__":
    main()
