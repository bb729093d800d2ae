"""TSV pair file -> fast_align "src ||| dst" format (reference
scripts/tab2fastalign.py). argv: input output"""
import sys

def main():
    with open(sys.argv[1]) as r, open(sys.argv[2], "w") as w:
        for line in r:
            spl = line.strip().split("\t")
            if len(spl) >= 2:
                w.write(spl[0] + " ||| " + spl[1] + "\n")

if __name__ == "__main__":
    main()
