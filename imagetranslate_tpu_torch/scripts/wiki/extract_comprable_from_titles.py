"""Comparable sentence candidates from interlanguage-linked docs: every
cross-language sentence pair within matched docs that passes length/number
filters; also dumps first-sentence pairs (reference
scripts/wiki/extract_comprable_from_titles.py).
argv: title_tsv src_docs dst_docs out_src out_dst out_first"""
import re
import sys

def has_number(s):
    return bool(re.search(r"\d", s))

def len_ok(w1, w2):
    return ((0.7 <= len(w1) / len(w2) <= 1.5
             or abs(len(w1) - len(w2)) <= 5)
            and len(w1) >= 5 and len(w2) >= 5)

def main():
    titles = {}
    with open(sys.argv[1]) as r:
        for line in r:
            spl = line.strip().split("\t")
            if len(spl) != 2:
                continue
            a, e = spl
            if "(" in a:
                a = a[:a.find("(")]
            titles[e] = a

    src_docs = {}
    with open(sys.argv[2]) as r:
        for line in r:
            sens = line.strip().split("</s>")
            title = sens[0][sens[0].find(">") + 1:].strip()
            src_docs[title] = sens[1:]

    found = 0
    with open(sys.argv[3]) as r, open(sys.argv[4], "w") as sw, \
            open(sys.argv[5], "w") as dw, open(sys.argv[6], "w") as fw:
        for line in r:
            sens = line.strip().split("</s>")
            title = sens[0][sens[0].find(">") + 1:].strip()
            src_title = titles.get(title)
            if src_title is None or src_title not in src_docs:
                continue
            src_sens = [s.replace("()", "").replace("  ", " ").strip()
                        for s in src_docs[src_title]]
            dst_sens = [s.replace("()", "").replace("  ", " ").strip()
                        for s in sens[1:]]
            if src_sens and dst_sens:
                fw.write(src_sens[0] + " ||| " + dst_sens[0] + "\n")
            for s in src_sens:
                ws = s.split(" ")
                for t in dst_sens:
                    wt = t.split(" ")
                    if not len_ok(ws, wt):
                        continue
                    if has_number(s) != has_number(t):
                        continue
                    sw.write(s + "\n")
                    dw.write(t + "\n")
                    found += 1
    print("Done!", found)

if __name__ == "__main__":
    main()
