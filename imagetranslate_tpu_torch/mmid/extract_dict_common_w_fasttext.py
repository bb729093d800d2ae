"""Keep dictionary entries whose words exist in both embedding vocabularies
(reference mmid/extract_dict_common_w_fasttext.py).
argv: src_embed en_embed dict output"""
import sys

def main():
    def vocab(path):
        words = set()
        with open(path) as r:
            for line in r:
                words.add(line.strip().split(" ")[0])
        return words

    src_words = vocab(sys.argv[1])
    en_words = vocab(sys.argv[2])
    with open(sys.argv[3]) as din, open(sys.argv[4], "w") as dout:
        for line in din:
            words = line.strip().split("\t")
            w = words[0] if words[0] in src_words else words[0].lower()
            if w not in src_words:
                continue
            for word in words[1:]:
                if word in en_words:
                    dout.write(w + " ||| " + word + "\n")
                elif word.lower() in en_words:
                    dout.write(w + " ||| " + word.lower() + "\n")

if __name__ == "__main__":
    main()
