"""Keep sentences whose word count is within [min,max]
(reference scripts/extract_sens_based_on_length_limit.py).
argv: input min max output"""
import sys

def main():
    lo, hi = int(sys.argv[2]), int(sys.argv[3])
    n = 0
    with open(sys.argv[1]) as r, open(sys.argv[4], "w") as w:
        for s in r:
            s = s.strip()
            if lo <= len(s.split(" ")) <= hi:
                w.write(s + "\n")
                n += 1
    print("Done", n)

if __name__ == "__main__":
    main()
