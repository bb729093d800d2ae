"""Build the marshal candidate dicts consumed by cli/score_pairs: sentence
list + src->candidate-ids map from comparable sentence files (reference
scripts/wiki/extract_trans_candidates_from_tltles_marshal.py produced
(sentences, src2dst_dict) marshal artifacts).
argv: src_sens dst_sens out_sens out_dict [max_cands=20]"""
import marshal
import sys

def main():
    max_cands = int(sys.argv[5]) if len(sys.argv) > 5 else 20
    sentences = {}
    ids = {}

    def sid(s):
        if s not in ids:
            ids[s] = len(ids)
            sentences[ids[s]] = s
        return ids[s]

    src2dst = {}
    with open(sys.argv[1]) as sr, open(sys.argv[2]) as dr:
        for s, t in zip(sr, dr):
            s_id = sid(s.strip())
            t_id = sid(t.strip())
            src2dst.setdefault(s_id, [])
            if len(src2dst[s_id]) < max_cands:
                src2dst[s_id].append(t_id)
    with open(sys.argv[3], "wb") as w:
        marshal.dump(sentences, w)
    with open(sys.argv[4], "wb") as w:
        marshal.dump(src2dst, w)
    print(len(sentences), "sentences,", len(src2dst), "sources")

if __name__ == "__main__":
    main()
