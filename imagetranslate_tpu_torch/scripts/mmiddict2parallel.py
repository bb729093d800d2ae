"""MMID-style multi-column dict ("src\\ttrans1\\ttrans2...") -> two parallel
files, one (src, trans_i) row per translation column (reference
scripts/mmiddict2parallel.py). The reference gates every column's emission
on len(src) > 1 AND len(spl[1]) > 1 — the FIRST translation's length, not
the current column's (mmiddict2parallel.py:10) — replicated as-is.
argv: dict out_src out_dst"""
import sys


def main():
    with open(sys.argv[1]) as r, open(sys.argv[2], "w") as w1, \
            open(sys.argv[3], "w") as w2:
        for line in r:
            spl = [s.strip() for s in line.strip().split("\t")]
            for i in range(1, len(spl)):
                if len(spl[0]) > 1 and len(spl[1]) > 1:
                    w1.write(spl[0] + "\n")
                    w2.write(spl[i] + "\n")


if __name__ == "__main__":
    main()
