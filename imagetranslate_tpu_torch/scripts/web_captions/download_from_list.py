"""Bulk-download raw URLs with wget (reference
scripts/web_captions/download_from_list.py). argv: list folder begin end"""
import os
import subprocess
import sys

def main():
    urls = open(sys.argv[1]).read().strip().split("\n")
    out = os.path.abspath(sys.argv[2])
    begin, end = int(sys.argv[3]), int(sys.argv[4])
    os.makedirs(out, exist_ok=True)
    log = os.path.join(out, "log.txt")
    for i, url in enumerate(urls[begin:end]):
        subprocess.run(["wget", "--tries=1", "--timeout=5", url, "-O",
                        os.path.join(out, str(i + begin)), "-o", log],
                       check=False)
    print("Done!")

if __name__ == "__main__":
    main()
