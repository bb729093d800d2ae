"""Scrape wikipedia pages for titles from a tagged-doc file (SIGALRM-guarded
urllib downloads; zero-egress environments record failures) — reference
scripts/wiki/extract_wikipedia_language_links.py.
--file docs --lang xx --output index --output_folder html_dir [--resume --end]"""
import argparse
import os
import signal
import time
import urllib.parse
import urllib.request

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
    p = argparse.ArgumentParser()
    p.add_argument("--file", required=True)
    p.add_argument("--lang", required=True)
    p.add_argument("--output", dest="output_file", required=True)
    p.add_argument("--output_folder", required=True)
    p.add_argument("--resume", type=int, default=0)
    p.add_argument("--end", type=int, default=100000000)
    a = p.parse_args()

    base = f"https://{a.lang}.wikipedia.org/wiki/"
    os.makedirs(a.output_folder, exist_ok=True)
    got = 0
    with open(a.file) as fp, open(a.output_file, "w") as w:
        for i, line in enumerate(fp):
            if i < a.resume or i >= a.end:
                continue
            title = line.strip().split("</s>")[0]
            title = title[title.find(">") + 1:].strip().replace(" ", "_")
            url = base + title
            w.write(f"{i}\t{title}\t{url}\n")
            parsed = urllib.parse.urlsplit(url)
            fixed = parsed._replace(
                path=urllib.parse.quote(parsed.path)).geturl()
            out_path = os.path.join(a.output_folder, f"{i}.html")
            for attempt in range(2):
                try:
                    fetch(fixed, out_path)
                    got += 1
                    break
                except Exception:
                    if attempt == 1:
                        print("unable to download", out_path, fixed)
                    time.sleep(1)
    print("Finished", got)

if __name__ == "__main__":
    main()
