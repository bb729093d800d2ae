"""Dedup + sort unique sentences by word count within [min,max]
(reference scripts/sort_based_on_len.py). argv: input output min max"""
import sys
from collections import defaultdict

def main():
    lo, hi = int(sys.argv[3]), int(sys.argv[4])
    by_len = defaultdict(set)
    with open(sys.argv[1]) as r:
        for line in r:
            line = line.strip()
            by_len[len(line.split(" "))].add(line)
    with open(sys.argv[2], "w") as w:
        for ln in sorted(by_len):
            if lo <= ln <= hi:
                w.write("\n".join(by_len[ln]) + "\n")

if __name__ == "__main__":
    main()
