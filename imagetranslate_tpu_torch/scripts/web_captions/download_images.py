"""Download caption-paired images from a "text\turl" list, resize to 256,
write an index file; SIGALRM timeouts per download (reference
scripts/web_captions/download_images.py). Zero-egress environments will
simply record failures. argv: list start end output_folder"""
import os
import signal
import sys
import urllib.request

EXTS = {"png", "jpg", "jpeg"}

class Timeout(Exception):
    pass

def fetch(url, path, seconds=300):
    def handler(signum, frame):
        raise Timeout()

    signal.signal(signal.SIGALRM, handler)
    signal.alarm(seconds)
    try:
        urllib.request.urlretrieve(url, path)
    finally:
        signal.alarm(0)

def main():
    from PIL import Image

    input_file = os.path.abspath(sys.argv[1])
    start, end = int(sys.argv[2]), int(sys.argv[3])
    out = os.path.abspath(sys.argv[4])
    os.makedirs(out, exist_ok=True)
    file_number = 1 + start
    count = 0
    with open(os.path.join(out, f"index.{start}.txt"), "w") as index, \
            open(input_file) as r:
        for line in r:
            count += 1
            if not (start <= count <= end):
                continue
            try:
                text, url = line.strip().split("\t")
            except ValueError:
                continue
            clean = url.split("?")[0]
            ext = clean.rsplit(".", 1)[-1].lower()
            if ext not in EXTS:
                continue
            path = os.path.join(out, f"{file_number}.{ext}")
            try:
                fetch(clean, path)
                with Image.open(path) as im:
                    if max(im.size) >= 256:
                        im.resize((256, 256)).save(path)
                    else:
                        continue
                index.write(f"{file_number}.{ext}\t{clean}\t{text}\n")
                file_number += 1
            except Exception:
                continue
    print("Written files", file_number)

if __name__ == "__main__":
    main()
