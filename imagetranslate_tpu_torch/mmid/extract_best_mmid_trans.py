"""Mutual-best word pairs from mmid_sim scores; words read from each
folder's word.txt (reference mmid/extract_best_mmid_trans.py).
--input sims_tsv --root prefix --output dict_tsv"""
import argparse
import os

def main():
    p = argparse.ArgumentParser()
    p.add_argument("--input", dest="input_file", required=True)
    p.add_argument("--root", dest="root_path", default="")
    p.add_argument("--output", dest="output_file", required=True)
    a = p.parse_args()

    def word_of(path):
        if not path.startswith("/"):
            path = os.path.join(a.root_path, path)
        return open(os.path.join(path, "word.txt")).read().strip()

    s2d, d2s = {}, {}
    with open(a.input_file) as r:
        for line in r:
            spl = line.strip().split("\t")
            if len(spl) != 3:
                continue
            try:
                sw, dw, sim = word_of(spl[0]), word_of(spl[1]), float(spl[2])
            except OSError:
                continue
            if sw not in s2d or sim > s2d[sw][1]:
                s2d[sw] = (dw, sim)
            if dw not in d2s or sim > d2s[dw][1]:
                d2s[dw] = (sw, sim)

    with open(a.output_file, "w") as w:
        for sw, (dw, sim) in s2d.items():
            if d2s[dw][0] == sw:
                w.write(sw + "\t" + dw + "\t" + str(sim) + "\n")
    print("Done!")

if __name__ == "__main__":
    main()
