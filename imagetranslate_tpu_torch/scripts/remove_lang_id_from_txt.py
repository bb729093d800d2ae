"""Strip the leading lang tag and trailing </s> from each line
(reference scripts/remove_lang_id_from_txt.py). argv: input output"""
import sys

def main():
    with open(sys.argv[1]) as r, open(sys.argv[2], "w") as w:
        for line in r:
            w.write(" ".join(line.strip().split(" ")[1:-1]) + "\n")

if __name__ == "__main__":
    main()
