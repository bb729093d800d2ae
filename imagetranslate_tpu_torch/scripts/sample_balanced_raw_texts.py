"""Sample equal-size monolingual corpora for two languages, preferring text
NOT present in the wiki-image JSONs (reference
scripts/sample_balanced_raw_texts.py behavior).
--l1j/--l2j image JSONs, --l1r/--l2r raw texts, --o1/--o2 outputs, --min_doc"""
import argparse
import json
import random

def docs_of(path):
    docs = set()
    with open(path) as fp:
        for v in json.load(fp):
            docs.add(v["content"].strip())
            docs |= {im["caption"] for im in v["images"]}
    return docs

def main():
    p = argparse.ArgumentParser()
    p.add_argument("--l1j", dest="l1_json", required=True)
    p.add_argument("--l2j", dest="l2_json", required=True)
    p.add_argument("--l1r", dest="l1_raw", required=True)
    p.add_argument("--l2r", dest="l2_raw", required=True)
    p.add_argument("--o1", required=True)
    p.add_argument("--o2", required=True)
    p.add_argument("--min_doc", type=int, default=1000000)
    a = p.parse_args()

    used1, used2 = docs_of(a.l1_json), docs_of(a.l2_json)

    def extra(path, used):
        out = []
        with open(path) as r:
            for line in r:
                line = line.strip()
                if line and line not in used:
                    out.append(line)
        return out

    pool1 = extra(a.l1_raw, used1)
    pool2 = extra(a.l2_raw, used2)
    n = min(len(pool1), len(pool2), a.min_doc)
    random.shuffle(pool1)
    random.shuffle(pool2)
    open(a.o1, "w").write("\n".join(sorted(used1) + pool1[:n]) + "\n")
    open(a.o2, "w").write("\n".join(sorted(used2) + pool2[:n]) + "\n")
    print(f"wrote {len(used1)}+{n} and {len(used2)}+{n} docs")

if __name__ == "__main__":
    main()
