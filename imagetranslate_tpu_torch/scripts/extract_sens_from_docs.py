"""Doc lines "<lang> sen </s> sen </s> ..." -> one tagged sentence per line,
length-filtered (reference scripts/extract_sens_from_docs.py).
argv: input min max output"""
import sys

def main():
    lo, hi = int(sys.argv[2]), int(sys.argv[3])
    with open(sys.argv[1]) as r, open(sys.argv[4], "w") as w:
        for line in r:
            line = line.strip()
            if not line:
                continue
            docs = line.split("</s>")
            head = docs[0].strip().split(" ")
            lang, docs[0] = head[0], " ".join(head[1:])
            sens = [" ".join([lang, s.strip(), "</s>"]) for s in docs
                    if s.strip() and lo <= len(s.strip().split(" ")) <= hi]
            if sens:
                w.write("\n".join(sens) + "\n")
    print("Done!")

if __name__ == "__main__":
    main()
