"""Symlink the unique image paths of a TSV list into a folder
(reference scripts/flickr/soft_link_images_to_folder.py). argv: tsv folder"""
import os
import sys

def main():
    out = os.path.abspath(sys.argv[2])
    seen = set()
    with open(sys.argv[1]) as r:
        for line in r:
            spl = line.strip().split("\t")
            if len(spl) < 2 or spl[0] in seen:
                continue
            seen.add(spl[0])
            target = os.path.join(out, os.path.basename(spl[0]))
            if not os.path.lexists(target):
                os.symlink(spl[0], target)

if __name__ == "__main__":
    main()
