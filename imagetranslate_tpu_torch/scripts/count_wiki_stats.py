"""Token/sentence/doc counts over tagged wiki text dumps (reference
scripts/count_wiki_stats.py). argv: input"""
import sys

def main():
    docs, sens, toks = 0, 0, 0
    with open(sys.argv[1]) as r:
        for line in r:
            line = line.strip()
            if not line:
                continue
            docs += 1
            for s in line.split("</s>"):
                if s.strip():
                    sens += 1
                    toks += len(s.strip().split(" "))
    print(docs, "docs,", sens, "sens,", toks, "tokens")

if __name__ == "__main__":
    main()
