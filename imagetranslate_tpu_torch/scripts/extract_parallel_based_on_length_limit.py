"""Keep parallel pairs where BOTH sides fit in [min,max] words
(reference scripts/extract_parallel_based_on_length_limit.py).
argv: src dst min max out_src out_dst"""
import sys

def main():
    lo, hi = int(sys.argv[3]), int(sys.argv[4])
    n = 0
    with open(sys.argv[1]) as r1, open(sys.argv[2]) as r2, \
            open(sys.argv[5], "w") as w1, open(sys.argv[6], "w") as w2:
        for s, t in zip(r1, r2):
            s, t = s.strip(), t.strip()
            if lo <= len(s.split(" ")) <= hi and lo <= len(t.split(" ")) <= hi:
                w1.write(s + "\n")
                w2.write(t + "\n")
                n += 1
    print("Done", n)

if __name__ == "__main__":
    main()
