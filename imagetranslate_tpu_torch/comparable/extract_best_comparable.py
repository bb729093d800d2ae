"""Mutual-best filtering of scored pairs with length-normalized scores
(reference comparable/extract_best_comparable.py:18-60).
--src --dst --scores --output --min"""
import argparse

def main():
    p = argparse.ArgumentParser()
    p.add_argument("--src", dest="src_file", required=True)
    p.add_argument("--dst", dest="dst_file", required=True)
    p.add_argument("--scores", dest="score_file", required=True)
    p.add_argument("--output", dest="output_file", required=True)
    p.add_argument("--min", dest="min_sim", type=float, default=0.1)
    a = p.parse_args()

    best_s2d, best_d2s = {}, {}
    with open(a.src_file) as sr, open(a.dst_file) as dr, \
            open(a.score_file) as scf:
        for src, dst, score in zip(sr, dr, scf):
            src, dst = src.strip(), dst.strip()
            norm = max(len(src.split(" ")), len(dst.split(" ")))
            s = float(score.strip()) / norm
            if src not in best_s2d or s > best_s2d[src][1]:
                best_s2d[src] = (dst, s)
            if dst not in best_d2s or s > best_d2s[dst][1]:
                best_d2s[dst] = (src, s)

    found = {}
    for src, (dst, s) in best_s2d.items():
        if best_d2s[dst][0] == src and s >= a.min_sim:
            found[src + " ||| " + dst] = s
    with open(a.output_file, "w") as w:
        for pair, s in sorted(found.items(), key=lambda kv: kv[1],
                              reverse=True):
            w.write(pair + "\t" + str(s) + "\n")
    print("Done!", len(found))

if __name__ == "__main__":
    main()
