"""Sort scored pair TSVs by score, dropping short (<5 word) sides
(reference scripts/wiki/extract_best_alignments_from_scores.py).
argv: input output"""
import sys

def main():
    pairs = {}
    with open(sys.argv[1]) as r:
        for line in r:
            spl = line.strip().split("\t")
            if len(spl) == 3 and len(spl[0].split(" ")) >= 5 \
                    and len(spl[1].split(" ")) >= 5:
                pairs[spl[0] + "\t" + spl[1]] = float(spl[2])
    with open(sys.argv[2], "w") as w:
        for pair, score in sorted(pairs.items(), key=lambda kv: kv[1],
                                  reverse=True):
            w.write(pair + "\t" + str(score) + "\n")

if __name__ == "__main__":
    main()
