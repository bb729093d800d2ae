"""Join a path\\tsrc-caption TSV against a "src ||| translation" file into
path\\ttranslation rows, keeping only captions that have a translation
(reference scripts/create_caption_list_from_translation.py — a DICT join
keyed on the source caption, not a line-aligned zip).
argv: translations caption_tsv output"""
import sys


def main():
    translations = {}
    with open(sys.argv[1]) as r:
        for line in r:
            spl = line.strip().split("|||")
            if len(spl) >= 2:
                translations[spl[0].strip()] = spl[1].strip()
    print("Extracted", len(translations), "unique translations!")

    with open(sys.argv[2]) as r, open(sys.argv[3], "w") as w:
        for line in r:
            spl = line.strip().split("\t")
            if len(spl) > 1 and spl[1] in translations:
                w.write(spl[0] + "\t" + translations[spl[1]] + "\n")


if __name__ == "__main__":
    main()
