"""Corpus stats: sentences, types, tokens; lang-tagged lines exclude the tag
and </s> from the token count (reference scripts/get_txt_stat.py).
argv: input"""
import sys

def main():
    sens, toks = 0, 0
    types = set()
    with open(sys.argv[1]) as r:
        for line in r:
            words = line.strip().split(" ")
            sens += 1
            toks += len(words) - 2 if words[0].startswith("<") else len(words)
            types |= set(words)
    print(sens, "sens,", len(types), "types,", toks, "tokens")

if __name__ == "__main__":
    main()
