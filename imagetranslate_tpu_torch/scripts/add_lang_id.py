"""Wrap each line as "<lang> line </s>" (reference scripts/add_lang_id.py).
argv: input lang output"""
import sys

def main():
    inp, lang, out = sys.argv[1], sys.argv[2], sys.argv[3]
    tag = f"<{lang}>"
    with open(inp) as r, open(out, "w") as w:
        for line in r:
            w.write(f"{tag} {line.strip()} </s>\n")

if __name__ == "__main__":
    main()
