"""Two parallel files -> lowercased fast_align input, skipping pairs with an
empty side (reference scripts/align2fastalign.py). argv: src dst output"""
import sys

def main():
    with open(sys.argv[1]) as r1, open(sys.argv[2]) as r2, \
            open(sys.argv[3], "w") as w:
        for n, (l1, l2) in enumerate(zip(r1, r2)):
            a, b = l1.strip().lower(), l2.strip().lower()
            if len(a) > 1 and len(b) > 1:
                w.write(a + " ||| " + b + "\n")
            else:
                print("Skipped", n + 1)
    print("Done")

if __name__ == "__main__":
    main()
