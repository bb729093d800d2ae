"""COCO annotations -> "abs_image_path\tcaption" TSV with zero-padded names
(reference scripts/get_coco_captions.py). argv: coco_json image_folder output"""
import json
import os
import sys
from collections import defaultdict

def main():
    with open(sys.argv[1]) as r:
        obj = json.load(r)
    folder = os.path.abspath(sys.argv[2])
    by_image = defaultdict(list)
    for ann in obj["annotations"]:
        img = str(ann["image_id"])
        name = "0" * (12 - len(img)) + img + ".jpg"
        by_image[name].append(ann["caption"].strip())
    with open(sys.argv[3], "w") as w:
        for name, captions in by_image.items():
            for caption in captions:
                w.write(os.path.join(folder, name) + "\t" + caption + "\n")
    print(len(by_image), "images,", len(obj["annotations"]), "captions")

if __name__ == "__main__":
    main()
