"""Swap the sides of a fast_align pair file + its alignment indices
(reference scripts/wiki/flip_alignment_dir.py).
argv: pairs alignments out_pairs out_alignments"""
import sys

def main():
    with open(sys.argv[1]) as r, open(sys.argv[2]) as ar, \
            open(sys.argv[3], "w") as w, open(sys.argv[4], "w") as aw:
        for line, aline in zip(r, ar):
            spl = line.strip().split(" ||| ")
            w.write(spl[1] + " ||| " + spl[0] + "\n")
            flipped = []
            for a in aline.strip().split(" "):
                parts = a.strip().split("-")
                # >=2 parts: the reference indexes [1]+"-"+[0], so a
                # malformed "1-2-3" flips to "2-1" (extra parts dropped),
                # it does not skip (flip_alignment_dir.py:18-21).
                if len(parts) >= 2:
                    flipped.append(parts[1] + "-" + parts[0])
            aw.write(" ".join(flipped) + "\n")

if __name__ == "__main__":
    main()
