"""Drop pairs whose digit sets differ after normalizing Persian/Gujarati/
Devanagari digits to ASCII (reference
comparable/filter_non_matched_numbers_from_parallel_data.py).
argv: pairs src dst output"""
import sys

REPL = {"۰": "0", "۱": "1", "۲": "2", "۳": "3", "۴": "4", "۵": "5", "۶": "6",
        "۷": "7", "۸": "8", "۹": "9", "٫": ".", "૦": "0", "०": "0", "૧": "1",
        "१": "1", "૨": "2", "२": "2", "૩": "3", "३": "3", "૪": "4", "४": "4",
        "૫": "5", "५": "5", "૬": "6", "६": "6", "૭": "7", "७": "7", "૮": "8",
        "८": "8", "૯": "9", "९": "9"}

def digits_of(text):
    out = set()
    for tok in text.split(" "):
        norm = "".join(REPL.get(c, c) for c in tok)
        if norm.replace(".", "", 1).isdigit():
            out.add(norm)
    return out

def main():
    removed = 0
    with open(sys.argv[1]) as r, open(sys.argv[2]) as r1, \
            open(sys.argv[3]) as r2, open(sys.argv[4], "w") as w:
        for line, src, dst in zip(r, r1, r2):
            if digits_of(src.strip()) == digits_of(dst.strip()):
                w.write(line.strip() + "\n")
            else:
                removed += 1
    print(removed)

if __name__ == "__main__":
    main()
