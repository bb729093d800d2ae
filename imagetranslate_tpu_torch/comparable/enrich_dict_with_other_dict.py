"""Union two TSV dictionaries, second one only for unseen words
(reference comparable/enrich_dict_with_other_dict.py).
argv: primary secondary output"""
import sys

def main():
    src_seen, dst_seen = set(), set()
    with open(sys.argv[1]) as r1, open(sys.argv[2]) as r2, \
            open(sys.argv[3], "w") as w:
        for line in r1:
            spl = line.strip().split("\t")
            if len(spl) >= 2:
                src_seen.add(spl[0])
                dst_seen.add(spl[1])
            w.write(line.strip() + "\n")
        for line in r2:
            spl = line.strip().split("\t")
            if len(spl) >= 2 and spl[0] not in src_seen and spl[1] not in dst_seen:
                w.write(line.strip() + "\n")

if __name__ == "__main__":
    main()
