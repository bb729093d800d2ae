"""Doc/sentence/type/image/caption stats over TWO wiki-image JSONs plus
their shared-image count (reference scripts/count_wiki_json_stat.py —
two-file contract). The "caption tokens" figure replicates the reference's
`len(caption) - 2` — a CHARACTER count minus two, not a word count
(count_wiki_json_stat.py:20) — so the printed stats match byte-for-byte.
argv: json1 json2"""
import json
import sys


def _stats(path):
    docs, sens = 0, 0
    types, images = set(), set()
    captions, caption_toks = 0, 0
    with open(path) as fp:
        for v in json.load(fp):
            docs += 1
            sens += len(v["content"].strip().split("</s>"))
            types |= set(v["content"].strip().split(" "))
            image_list = [img["img_path"] for img in v["images"]]
            images |= set(image_list)
            caption_toks += sum(len(img["caption"]) - 2
                                for img in v["images"])
            captions += len(image_list)
    return docs, sens, types, images, captions, caption_toks


def main():
    shared = []
    for path in (sys.argv[1], sys.argv[2]):
        docs, sens, types, images, captions, toks = _stats(path)
        print(docs, "docs,", sens, "sens,", len(types), "types,",
              len(images), "images,", captions, "captions,", toks,
              "caption tokens")
        shared.append(images)
    print("Shared images:", len(shared[0] & shared[1]))


if __name__ == "__main__":
    main()
