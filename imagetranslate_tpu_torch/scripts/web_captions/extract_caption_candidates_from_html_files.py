"""Mine <img alt=...>/<figcaption> caption candidates from saved HTML trees
(reference scripts/web_captions/extract_caption_candidates_from_html_files.py,
which also ran a fasttext language-id filter; this version has no
language-id step).
argv: html_root output [min_words=4]"""
import os
import sys

def captions_from_html(content):
    from bs4 import BeautifulSoup

    soup = BeautifulSoup(content, "html.parser")
    out = []
    for img in soup.find_all("img"):
        alt = (img.get("alt") or "").strip()
        src = img.get("src") or ""
        if alt and src:
            out.append((src, alt))
    for fig in soup.find_all("figcaption"):
        text = fig.get_text(" ", strip=True)
        img = fig.find_parent("figure")
        img = img.find("img") if img else None
        if text and img is not None and img.get("src"):
            out.append((img["src"], text))
    return out

def main():
    root = os.path.abspath(sys.argv[1])
    min_words = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    wrote = 0
    with open(sys.argv[2], "w") as w:
        for dirpath, _, names in os.walk(root):
            for name in names:
                if not name.endswith((".html", ".htm")):
                    continue
                try:
                    content = open(os.path.join(dirpath, name),
                                   errors="ignore").read()
                    for src, caption in captions_from_html(content):
                        if len(caption.split(" ")) >= min_words:
                            w.write(src + "\t" + caption + "\n")
                            wrote += 1
                except Exception:
                    continue
    print("Wrote", wrote)

if __name__ == "__main__":
    main()
