"""Parse saved wikipedia HTML for the English interlanguage link, emitting
"title\ten_title" pairs (reference
scripts/wiki/extract_wiki_en_equivalent_from_html_files.py).
argv: html_folder output"""
import os
import sys
import urllib.parse

def main():
    from bs4 import BeautifulSoup

    folder = os.path.abspath(sys.argv[1])
    wrote = 0
    with open(sys.argv[2], "w") as fp:
        for name in os.listdir(folder):
            path = os.path.join(folder, name)
            try:
                soup = BeautifulSoup(open(path).read(), "html.parser")
                title = soup.find("div", id="content").find("h1").text.strip()
                nav = soup.find("nav", id="p-lang").find("ul")
                en = nav.find("li", {"class":
                                     "interlanguage-link interwiki-en"})
                href = en.find("a")["href"]
                trans = href[href.find("wiki/") + 5:].replace("_", " ")
                fp.write(urllib.parse.unquote(title) + "\t"
                         + urllib.parse.unquote(trans) + "\n")
                wrote += 1
            except Exception:
                continue
    print("Wrote", wrote)

if __name__ == "__main__":
    main()
