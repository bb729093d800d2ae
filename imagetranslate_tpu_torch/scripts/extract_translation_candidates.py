"""Translation-candidate pairs from two languages' wiki-image JSONs, keyed
by shared images: each doc sentence/caption pairs with the reference side's
captions for the same image under a length-ratio filter (reference
scripts/extract_translation_candidates.py).
--file src_json --ref ref_json --output out [--txt] [--image]"""
import argparse
import json
import marshal
from collections import defaultdict
from itertools import chain

def len_ok(w1, w2):
    return (0.9 <= len(w1) / len(w2) <= 1.1
            or abs(len(w1) - len(w2)) <= 3)

def doc_sentences(v, min_words=5):
    spl = v["content"].strip().split(" ")
    lang_id = spl[0] + " "
    content = " ".join(spl[1:])
    return [lang_id + s.strip() + " </s>" for s in content.split("</s>")
            if len(s.strip().split(" ")) >= min_words]

def main():
    p = argparse.ArgumentParser()
    p.add_argument("--file", required=True)
    p.add_argument("--ref", required=True)
    p.add_argument("--output", dest="output_file", required=True)
    p.add_argument("--image", dest="output_image", action="store_true")
    p.add_argument("--txt", action="store_true")
    a = p.parse_args()

    with open(a.ref) as fp:
        ref_docs = json.load(fp)
    ref_images = set(chain(*[[im["img_path"] for im in v["images"]]
                             for v in ref_docs]))
    ref_caption_dict = defaultdict(set)
    for v in ref_docs:
        # Reference side gates sentences to 5..256 words (the 256 cap is
        # ref-side only: extract_translation_candidates.py:21 vs :35).
        sens = [s for s in doc_sentences(v)
                if len(s.strip().split(" ")) <= 256 + 2]
        for im in v["images"]:
            ref_caption_dict[im["img_path"]].add(im["caption"])
            for s in sens:
                ref_caption_dict[im["img_path"]].add(s)

    sen_ids = {}
    src2dst = defaultdict(set)
    dst2src = defaultdict(set)
    mode = "w" if a.txt else "wb"
    with open(a.file) as fp, open(a.output_file, mode) as writer:
        for v in json.load(fp):
            shared = [im["img_path"] for im in v["images"]
                      if im["img_path"] in ref_images]
            if not shared:
                continue
            sens = doc_sentences(v)
            captions = {im["img_path"]: im["caption"] for im in v["images"]}
            pairs = []
            for img in shared:
                cands = sens + [captions[img]]
                for ref_sen in ref_caption_dict[img]:
                    for s in cands:
                        if len_ok(s.split(" "), ref_sen.split(" ")):
                            pairs.append((img, s, ref_sen) if a.output_image
                                         else (s, ref_sen))
            if not pairs:
                continue
            if a.txt:
                lines = [" ".join([" ".join(pr[-2].split(" ")[1:-1]), "|||",
                                   " ".join(pr[-1].split(" ")[1:-1])])
                         for pr in pairs]
                writer.write("\n".join(lines) + "\n")
            else:
                for pr in pairs:
                    src, dst = pr[-2], pr[-1]
                    sen_ids.setdefault(src, len(sen_ids))
                    sen_ids.setdefault(dst, len(sen_ids))
                    src2dst[sen_ids[src]].add(sen_ids[dst])
                    dst2src[sen_ids[dst]].add(sen_ids[src])
        if not a.txt:
            marshal.dump((sen_ids, {k: list(v) for k, v in src2dst.items()},
                          {k: list(v) for k, v in dst2src.items()}), writer)
    print("Done!", len(sen_ids), "sentences")

if __name__ == "__main__":
    main()
