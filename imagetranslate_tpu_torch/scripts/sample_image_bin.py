"""Subsample a caption binary (unique_images, captions) to its first N
captions, keeping only referenced images (reference scripts/sample_image_bin.py).
argv: input_bin count output_bin"""
import marshal
import sys

def main():
    with open(sys.argv[1], "rb") as fp:
        unique_images, captions = marshal.load(fp)
    count = int(sys.argv[2])
    kept = captions[:count]
    used = {img_id for img_id, _ in kept}
    images = {i: p for i, p in unique_images.items() if i in used}
    with open(sys.argv[3], "wb") as w:
        marshal.dump((images, kept), w)
    print(len(kept), "captions,", len(images), "images")

if __name__ == "__main__":
    main()
