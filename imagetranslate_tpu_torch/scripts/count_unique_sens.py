"""Count unique lines (reference scripts/count_unique_sens.py). argv: input"""
import sys

def main():
    seen = set()
    with open(sys.argv[1]) as r:
        for line in r:
            seen.add(line)
    print(len(seen))

if __name__ == "__main__":
    main()
