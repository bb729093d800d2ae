"""Split "src ||| dst" lines back into two files (reference
scripts/fastalign2align.py). argv: input out_src out_dst"""
import sys

def main():
    with open(sys.argv[1]) as r, open(sys.argv[2], "w") as w1, \
            open(sys.argv[3], "w") as w2:
        for line in r:
            spl = line.strip().split(" ||| ")
            if len(spl) < 2:
                continue
            w1.write(spl[0] + "\n")
            w2.write(" ".join(spl[1:]).strip() + "\n")

if __name__ == "__main__":
    main()
