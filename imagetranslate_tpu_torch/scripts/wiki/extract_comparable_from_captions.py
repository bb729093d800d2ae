"""Comparable caption pairs across wiki-image JSONs of two languages, keyed
by shared image path (reference scripts/wiki/extract_comparable_from_captions.py
behavior). argv: json1 json2 out_src out_dst"""
import json
import sys

def main():
    def captions_of(path):
        by_img = {}
        with open(path) as fp:
            for v in json.load(fp):
                for img in v["images"]:
                    by_img.setdefault(img["img_path"], []).append(
                        img["caption"])
        return by_img

    c1 = captions_of(sys.argv[1])
    c2 = captions_of(sys.argv[2])
    shared = set(c1) & set(c2)
    found = 0
    with open(sys.argv[3], "w") as sw, open(sys.argv[4], "w") as dw:
        for img in shared:
            for a in c1[img]:
                for b in c2[img]:
                    sw.write(a.strip() + "\n")
                    dw.write(b.strip() + "\n")
                    found += 1
    print("Done!", found, "pairs from", len(shared), "shared images")

if __name__ == "__main__":
    main()
