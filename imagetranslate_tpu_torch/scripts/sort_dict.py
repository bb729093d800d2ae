"""Filter+sort scored pairs (TSV src\ttgt\tscore), keep best per source
(reference scripts/sort_dict.py). argv: input output threshold min_len"""
import sys

def main():
    threshold, min_len = float(sys.argv[3]), int(sys.argv[4])
    pairs = {}
    with open(sys.argv[1]) as r:
        for line in r:
            spl = line.strip().split("\t")
            if len(spl) != 3 or float(spl[2]) < threshold:
                continue
            s, t = spl[0].strip(), spl[1].strip()
            if s.lower() == t.lower() or "." in s or "." in t:
                continue
            if len(s.split(" ")) < min_len or len(t.split(" ")) < min_len:
                continue
            pairs[s + "\t" + t] = float(spl[2])
    covered = set()
    with open(sys.argv[2], "w") as w:
        for key, score in sorted(pairs.items(), key=lambda kv: kv[1],
                                 reverse=True):
            s = key.split("\t")[0]
            if s not in covered:
                covered.add(s)
                w.write(key + "\t" + str(score) + "\n")

if __name__ == "__main__":
    main()
