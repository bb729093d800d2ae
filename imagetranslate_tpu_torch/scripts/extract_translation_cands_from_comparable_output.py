"""From forced-decode candidate scores, keep pairs that are mutual best in
both directions with log-prob sum above a limit (reference
scripts/extract_translation_cands_from_comparable_output.py).
argv: input output [limit=-13]"""
import sys

def main():
    limit = float(sys.argv[3]) if len(sys.argv) > 3 else -13.0
    cands = {}
    with open(sys.argv[1]) as r:
        for line in r:
            spl = line.strip().split("\t")
            if len(spl) == 3:
                cands[spl[0]] = (spl[1], spl[2])
    shared = {}
    first_lang = None
    for s1, (s2, p1) in cands.items():
        lang = s1.strip().split(" ")[0]
        if first_lang is None:
            first_lang = lang
        if s2 not in cands or s2 in shared:
            continue
        s3, p2 = cands[s2]
        if s3.lower().strip() == s1.lower().strip():
            p12 = float(p1) + float(p2)
            if p12 >= limit and lang == first_lang:
                shared[s1] = (s2, p1, p2, str(p12))
    with open(sys.argv[2], "w") as w:
        for s1, (s2, p1, p2, p12) in shared.items():
            w.write("\t".join([s1, s2, p1, p2, p12]) + "\n")
    print("Done!")

if __name__ == "__main__":
    main()
