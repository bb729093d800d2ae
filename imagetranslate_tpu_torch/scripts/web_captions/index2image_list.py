"""Resolve index-file names to existing image files with extension sniffing
(reference scripts/web_captions/index2image_list.py). argv: index dir output"""
import os
import sys

def main():
    d = os.path.abspath(sys.argv[2])
    wrote = 0
    with open(sys.argv[1]) as r, open(sys.argv[3], "w") as w:
        for line in r:
            spl = line.strip().split("\t")
            base = os.path.join(d, spl[0])
            for ext in (".jpg", ".jpeg", ".JPG", ".JPEG", ""):
                if os.path.exists(base + ext):
                    w.write(base + ext + "\t" + spl[-1] + "\n")
                    wrote += 1
                    break
    print("WROTE", wrote)

if __name__ == "__main__":
    main()
