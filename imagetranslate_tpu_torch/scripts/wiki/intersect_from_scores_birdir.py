"""Bidirectional mutual-best intersection over a scored TSV
("src\tdst\tscore"): keep pairs that pick each other, score >= lowest and
score-sum >= lowest_sum, 8..50 words per side, deduped with a canonical
direction (reference scripts/wiki/intersect_from_scores_birdir.py).
argv: input lowest lowest_sum output"""
import sys

def main():
    lowest, lowest_sum = float(sys.argv[2]), float(sys.argv[3])
    forward = {}
    with open(sys.argv[1]) as r:
        for line in r:
            try:
                # First three TAB fields; extra trailing fields tolerated
                # (the reference indexes [0..2], intersect_from_scores_
                # birdir.py:15-17).
                fields = line.strip().split("\t")
                src, dst, p = fields[0], fields[1], float(fields[2])
            except (ValueError, IndexError):
                continue
            if (8 <= len(src.split(" ")) <= 50
                    and 8 <= len(dst.split(" ")) <= 50 and p >= lowest):
                forward[src] = (dst, p)
    found = 0
    added = set()
    with open(sys.argv[4], "w") as w:
        for src, (dst, p1) in forward.items():
            if dst not in forward or forward[dst][0] != src:
                continue
            p2 = forward[dst][1]
            if p1 + p2 < lowest_sum:
                continue
            l1, l2 = src.split(" ")[0], dst.split(" ")[0]
            a, b = (dst, src) if l1 > l2 else (src, dst)
            if a in added:
                continue
            added.add(a)
            w.write(a + " ||| " + b + "\t" + str(p1) + "\t" + str(p2)
                    + "\t" + str(p1 + p2) + "\n")
            found += 1
    print("done!", found)

if __name__ == "__main__":
    main()
