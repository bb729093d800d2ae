"""Word/char vocabulary overlap between two corpora
(reference scripts/count_shared_words.py). argv: file1 file2"""
import sys

def main():
    def vocab(path):
        words, chars = set(), set()
        with open(path) as r:
            for line in r:
                line = line.strip()
                words |= set(line.split(" "))
                chars |= set(line)
        return words, chars

    w1, c1 = vocab(sys.argv[1])
    w2, c2 = vocab(sys.argv[2])
    print(len(w1), len(w2), len(w1 & w2))
    print(len(c1), len(c2), len(c1 & c2))

if __name__ == "__main__":
    main()
