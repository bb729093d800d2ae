"""Wiki-image JSON docs -> tagged sentences from docs that HAVE images
(reference scripts/extract_sens_from_img_docs.py). argv: json min max output"""
import json
import sys

def main():
    lo, hi = int(sys.argv[2]), int(sys.argv[3])
    with open(sys.argv[1]) as fp, open(sys.argv[4], "w") as w:
        for v in json.load(fp):
            if not v["images"]:
                continue
            spl = v["content"].strip().split(" ")
            # lang carries a trailing space, so the join yields a DOUBLE
            # space after the tag ("<fa>  sen </s>") — and a doc with
            # images but no qualifying sentence still writes a blank line
            # (extract_sens_from_img_docs.py:17-23); both replicated for
            # byte parity with reference-produced corpora.
            lang, content = spl[0] + " ", " ".join(spl[1:])
            sens = [" ".join([lang, s.strip(), "</s>"])
                    for s in content.split("</s>")
                    if s.strip() and lo <= len(s.strip().split(" ")) <= hi]
            w.write("\n".join(sens) + "\n")
    print("Done!")

if __name__ == "__main__":
    main()
