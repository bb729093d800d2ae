"""Mine first-sentence pairs from interlanguage-linked wiki docs: match docs
via the title dict, take each doc's first sentence, filter by length ratio,
digit consistency, and common wiki boilerplate
(reference scripts/wiki/extract_first_sens_from_titles.py).
argv: title_tsv src_docs dst_docs output"""
import re
import sys

GUJ_DIGITS = set("૦૧૨૩૪૫૬૭૮૯०१२३४५६७८९")

def has_number(s):
    return bool(re.search(r"\d", s)) or any(c in GUJ_DIGITS for c in s)

def len_ok(w1, w2):
    return ((0.7 <= len(w1) / len(w2) <= 1.3 or abs(len(w1) - len(w2)) <= 5)
            and len(w1) >= 5 and len(w2) >= 5)

def main():
    titles = {}
    with open(sys.argv[1]) as r:
        for line in r:
            spl = line.strip().split("\t")
            if len(spl) == 2:
                a, e = spl
                if "(" in a:
                    a = a[:a.find("(")]
                titles[e] = a

    src_docs = {}
    with open(sys.argv[2]) as r:
        for line in r:
            sens = line.strip().split("</s>")
            title = sens[0][sens[0].find(">") + 1:].strip()
            src_docs[title] = sens[1:]

    found = 0
    with open(sys.argv[3]) as r, open(sys.argv[4], "w") as w:
        for line in r:
            sens = line.strip().split("</s>")
            title = sens[0][sens[0].find(">") + 1:].strip()
            src_title = titles.get(title)
            if src_title is None or src_title not in src_docs:
                continue
            src_sens = src_docs[src_title]
            if len(sens) < 2 or not src_sens:
                continue
            first = sens[1].replace("()", "").replace("  ", " ").strip()
            src_first = src_sens[0].replace("()", "").replace("  ", " ").strip()
            if len(first) < 5 or first.startswith("AD "):
                continue
            if first.lower().startswith("early life") or "list of" in first.lower():
                continue
            if has_number(first[0]):
                continue
            if has_number(first) != has_number(src_first):
                continue
            if not len_ok(src_first.split(" "), first.split(" ")):
                continue
            if src_first.lower() == first.lower():
                continue
            w.write(src_first + " ||| " + first + "\n")
            found += 1
    print("Done!", found)

if __name__ == "__main__":
    main()
