"""Comparable "src ||| cand1 ||| cand2 ..." lines -> one (src, cand) pair per
candidate; optional 4th arg "skip" drops 2-column title-only rows
(reference scripts/fastalign_comp2align.py). argv: input out_src out_dst [skip]"""
import sys

def main():
    skip_titles = len(sys.argv) > 4 and sys.argv[4] == "skip"
    skipped = 0
    with open(sys.argv[1]) as r, open(sys.argv[2], "w") as w1, \
            open(sys.argv[3], "w") as w2:
        for line in r:
            spl = line.strip().split(" ||| ")
            if len(spl) < 2:
                continue
            if len(spl) == 2 and skip_titles:
                skipped += 1
                continue
            for cand in spl[1:]:
                w1.write(spl[0] + "\n")
                w2.write(cand.strip() + "\n")
    print("skipped", skipped)

if __name__ == "__main__":
    main()
