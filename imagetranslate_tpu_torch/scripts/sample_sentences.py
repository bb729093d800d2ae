"""Random sample of length-filtered sentences (reference
scripts/sample_sentences.py). argv: input count min_len max_len output"""
import random
import sys

def main():
    inp, count = sys.argv[1], int(sys.argv[2])
    lo, hi, out = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
    kept = []
    with open(inp) as r:
        for line in r:
            if lo <= len(line.strip().split(" ")) <= hi:
                kept.append(line.strip())
    random.shuffle(kept)
    with open(out, "w") as w:
        w.write("\n".join(kept[:count + 1]))

if __name__ == "__main__":
    main()
