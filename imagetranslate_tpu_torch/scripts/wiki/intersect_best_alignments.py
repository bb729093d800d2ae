"""Keep pairs that are mutual best in forward/backward scored files
("src ||| dst\tscore" lines); product of the two scores is the output score
(reference scripts/wiki/intersect_best_alignments.py).
argv: forward backward output"""
import sys

def main():
    forward = {}
    with open(sys.argv[1]) as r:
        for line in r:
            pair, score = line.strip().split("\t")
            s, d = pair.strip().split(" ||| ")
            forward[s] = (d, float(score))
    found = 0
    with open(sys.argv[2]) as r, open(sys.argv[3], "w") as w:
        for line in r:
            pair, score = line.strip().split("\t")
            d, s = pair.strip().split(" ||| ")[0], pair.strip().split(" ||| ")[1]
            if s in forward and forward[s][0] == d:
                prob = float(score) * forward[s][1]
                w.write(s + " ||| " + d + "\t" + str(prob) + "\n")
                found += 1
    print("done!", found)

if __name__ == "__main__":
    main()
