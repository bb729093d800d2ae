"""COCO annotations -> TSV list with newline-scrubbed captions (reference
scripts/coco_json_to_list.py). argv: coco_json image_dir output"""
import json
import os
import sys
from collections import defaultdict

def main():
    with open(sys.argv[1]) as r:
        obj = json.load(r)
    d = os.path.abspath(sys.argv[2])
    by_image = defaultdict(list)
    for ann in obj["annotations"]:
        # \r\n DELETED, not spaced (reference coco_json_to_list.py:18 —
        # "line1\nline2" becomes "line1line2"): list files feed binaries
        # whose captions must match the reference's byte-for-byte.
        caption = ann["caption"].replace("\r", "").replace("\n", "").strip()
        img = str(ann["image_id"])
        path = os.path.join(d, "0" * (12 - len(img)) + img + ".jpg")
        by_image[path].append(caption)
    with open(sys.argv[3], "w") as w:
        for path, captions in by_image.items():
            for caption in captions:
                w.write(path + "\t" + caption + "\n")
    print(len(by_image), "images,", len(obj["annotations"]), "captions")

if __name__ == "__main__":
    main()
