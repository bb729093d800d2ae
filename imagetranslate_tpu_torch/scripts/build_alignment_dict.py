"""Top-5 normalized translation dict over TOKEN IDS from word alignments —
feeds the --dict lexical proposals (reference build_alignment_dict.py:30-62).
--src/--dst parallel text, --align fast_align output, --tok tokenizer,
--output "src_id cand1 ... cand5" lines."""
import argparse
from collections import defaultdict

def main():
    p = argparse.ArgumentParser()
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--align", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--tok", required=True)
    a = p.parse_args()

    from imagetranslate_tpu_torch.text.processor import TextProcessor

    tp = TextProcessor(a.tok)
    trans = defaultdict(lambda: defaultdict(int))
    counts = defaultdict(int)
    with open(a.src) as sr, open(a.dst) as dr, open(a.align) as ar:
        for src_line, dst_line, align_line in zip(sr, dr, ar):
            sw = src_line.strip().split(" ")
            dw = dst_line.strip().split(" ")
            for al in align_line.strip().split(" "):
                if "-" not in al:
                    continue
                i, j = al.split("-")
                try:
                    s_id = tp.token_id(sw[int(i)])
                    d_id = tp.token_id(dw[int(j)])
                except (ValueError, IndexError):
                    continue
                trans[s_id][d_id] += 1
                trans[d_id][s_id] += 1
                counts[s_id] += 1
                counts[d_id] += 1

    with open(a.output, "w") as w:
        for word, cands in trans.items():
            # (The reference divides by counts[word] before sorting; the
            # per-word denominator is constant so count order == normalized
            # order and the division is output-invariant.)
            # Stable sort on the count alone (== the reference's normalized
            # score, build_alignment_dict.py:57): equal-count candidates
            # keep first-seen order, NOT token-id order.
            scored = sorted(cands.items(), key=lambda kv: kv[1],
                            reverse=True)[:5]
            w.write(" ".join([str(word)] + [str(t) for t, _ in scored])
                    + "\n")

if __name__ == "__main__":
    main()
