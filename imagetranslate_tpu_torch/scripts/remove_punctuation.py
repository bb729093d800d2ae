"""Replace punctuation (incl. Arabic marks) with spaces, squeeze whitespace
(reference scripts/remove_punctuation.py). argv: input output"""
import sys

PUNCT = set("!()-[]{};:'\"\\,<>./?@#$%^&*_~؛،؟")

def main():
    with open(sys.argv[1]) as r, open(sys.argv[2], "w") as w:
        for line in r:
            cleaned = "".join(" " if c in PUNCT else c for c in line.strip())
            w.write(" ".join(cleaned.split()) + "\n")

if __name__ == "__main__":
    main()
