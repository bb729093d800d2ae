"""Round embedding-file float values to 4 decimals (reference
scripts/round_embedding_values.py). argv: input output"""
import sys

def main():
    with open(sys.argv[1]) as r, open(sys.argv[2], "w") as w:
        for line in r:
            spl = line.strip().split(" ")
            spl[1:] = [str(round(float(x), 4)) for x in spl[1:]]
            w.write(" ".join(spl) + "\n")

if __name__ == "__main__":
    main()
