"""TSV title pairs -> "src ||| dst", dropping entries with parentheses
(reference scripts/wiki/extract_clean_titles.py). argv: input output"""
import sys

def main():
    found = 0
    with open(sys.argv[1]) as r, open(sys.argv[2], "w") as w:
        for line in r:
            try:
                src, dst = line.strip().split("\t")
            except ValueError:
                continue
            if "(" not in src and "(" not in dst:
                w.write(src + " ||| " + dst + "\n")
                found += 1
    print("Done!", found)

if __name__ == "__main__":
    main()
