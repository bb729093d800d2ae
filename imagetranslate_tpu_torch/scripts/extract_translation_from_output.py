"""Split a bleu.output transcript (6-line stanzas: src/trans/gold/...) into
.src/.trans/.gold files (reference scripts/extract_translation_from_output.py).
argv: input output_prefix"""
import sys

def main():
    content = open(sys.argv[1]).read().strip().split("\n")
    out = sys.argv[2]
    src, trans, gold = [], [], []
    for i, line in enumerate(content):
        r = (i + 1) % 6
        if r == 1:
            src.append(line)
        elif r == 2:
            trans.append(line)
        elif r == 3:
            gold.append(line)
    print(len(src), len(gold), len(trans))
    open(out + ".src", "w").write("\n".join(src) + "\n")
    open(out + ".gold", "w").write("\n".join(gold) + "\n")
    open(out + ".trans", "w").write("\n".join(trans) + "\n")

if __name__ == "__main__":
    main()
