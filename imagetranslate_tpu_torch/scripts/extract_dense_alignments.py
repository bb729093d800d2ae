"""Keep pairs whose alignment density >= min_density with compatible lengths
(reference scripts/extract_dense_alignments.py).
argv: src dst alignments min_density output"""
import sys

def main():
    min_density = float(sys.argv[4])
    written = 0
    with open(sys.argv[1]) as sr, open(sys.argv[2]) as dr, \
            open(sys.argv[3]) as ar, open(sys.argv[5], "w") as w:
        for src, dst, alignment in zip(sr, dr, ar):
            sw = src.strip().split(" ")
            dw = dst.strip().split(" ")
            aligns = alignment.strip().split(" ")
            density = len(aligns) / max(len(sw), len(dw))
            len_ok = (0.9 <= len(sw) / len(dw) <= 1.1
                      or abs(len(sw) - len(dw)) <= 5)
            if (density >= min_density and len(sw) >= 5 and len(dw) >= 5
                    and len_ok):
                w.write(src.strip() + " ||| " + dst.strip() + "\n")
                written += 1
    print("Done!", written)

if __name__ == "__main__":
    main()
