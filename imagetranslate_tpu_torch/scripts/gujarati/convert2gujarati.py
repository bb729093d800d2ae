"""Devanagari -> Gujarati transliteration (reference
scripts/gujarati/convert2gujarati.py used indic_transliteration; this
first-party version maps the Unicode blocks directly: Gujarati U+0A80-0AFF
mirrors Devanagari U+0900-097F at a fixed offset for the shared letters).
argv: input output"""
import sys

OFFSET = 0x0A80 - 0x0900

def translit(ch):
    cp = ord(ch)
    if 0x0900 <= cp <= 0x097F:
        target = cp + OFFSET
        # A handful of Devanagari codepoints have no Gujarati counterpart;
        # leave those unchanged.
        if 0x0A80 <= target <= 0x0AFF:
            return chr(target)
    return ch

def main():
    with open(sys.argv[1]) as r, open(sys.argv[2], "w") as w:
        for line in r:
            w.write("".join(translit(c) for c in line.rstrip("\n")) + "\n")
    print("Done!")

if __name__ == "__main__":
    main()
