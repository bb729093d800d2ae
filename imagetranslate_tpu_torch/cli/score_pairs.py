"""Forced-decode rescoring of mined translation candidates (port of
imagetranslate_tpu/cli/score_pairs.py).

Inputs: ``--sens``, a marshal ``{sid: "<lang> text </s>"}``, and ``--data``,
a marshal ``{src_sid: [candidate sids]}``. Output: the best candidate of
each source as "src\\tbest candidate\\tscore", the score the mean
teacher-forced log-probability (``decoding.scoring.forced_score``).
``--resume R --end E`` keep the JAX CLI's shard window: the 1-based items
R + 1 .. E - 1, so adjacent shards overlap by one (``--end 100``, then
``--resume 99``).

    python -m imagetranslate_tpu_torch.cli.score_pairs --tok TOKDIR \
        --model MODELDIR --sens sens.marshal --data cands.marshal \
        --output best.tsv [--device cuda]
"""

from __future__ import annotations

import argparse
import marshal
import sys

import numpy as np
import torch


def get_parser():
    p = argparse.ArgumentParser("score_pairs")
    p.add_argument("--tok", dest="tokenizer_path", required=True)
    p.add_argument("--model", dest="model_path", required=True)
    p.add_argument("--capacity", dest="total_capacity", type=int,
                   default=2000)
    p.add_argument("--data", required=True)
    p.add_argument("--sens", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--resume", dest="resume_index", type=int, default=0)
    p.add_argument("--end", dest="end_index", type=int, default=-1)
    p.add_argument("--device", default="cuda",
                   help="torch device to score on (cuda, cuda:N or cpu)")
    return p


def main(argv=None):
    options = get_parser().parse_args(argv)

    from imagetranslate_tpu_torch.cli.translate import build_model
    from imagetranslate_tpu_torch.data.loader import bucket_len
    from imagetranslate_tpu_torch.decoding.scoring import forced_score

    model, cfg, tp = build_model(options)
    device = torch.device(options.device)

    with open(options.sens, "rb") as fp:
        sentences = marshal.load(fp)
    with open(options.data, "rb") as fp2:
        src2dst_dict = marshal.load(fp2)

    def tok(s):
        return tp.tokenize_one_sentence(s)[:cfg.max_position_embeddings]

    def dev(a):
        return torch.as_tensor(a).to(device)

    pad = tp.pad_token_id()
    max_cap = options.total_capacity * 1_000_000
    with open(options.output, "w") as writer:
        for index, sid in enumerate(src2dst_dict.keys()):
            if options.end_index > 0 and index + 1 >= options.end_index:
                break
            if index + 1 <= options.resume_index:
                continue
            tids = list(src2dst_dict[sid])
            src_ids = tok(sentences[sid])
            cands = [tok(sentences[t]) for t in tids]
            S = bucket_len(len(src_ids))
            T = bucket_len(max(len(c) for c in cands))
            # Candidates split so that 2 * max(S, T)^3 bytes a row stay
            # within the capacity.
            cur_cap = 2 * (max(S, T) ** 3) * len(cands)
            n_splits = max(1, -(-cur_cap // max_cap))
            split = max(1, len(cands) // n_splits)

            src_lang = tp.lang_id(sentences[sid].strip().split(" ")[0])
            scores = {}
            for s0 in range(0, len(cands), split):
                chunk = cands[s0:s0 + split]
                chunk_tids = tids[s0:s0 + split]
                n = len(chunk)
                src = np.full((n, S), pad, np.int32)
                src[:, :len(src_ids)] = src_ids
                tgt = np.full((n, T), pad, np.int32)
                for i, c in enumerate(chunk):
                    tgt[i, :len(c)] = c
                dst_langs = np.array(
                    [tp.lang_id(sentences[t].strip().split(" ")[0])
                     for t in chunk_tids], np.int32)
                sc = forced_score(
                    model, dev(src), dev(src != pad), dev(tgt),
                    dev(tgt != pad), dev(np.full((n,), src_lang, np.int32)),
                    dev(dst_langs))
                for t, v in zip(chunk_tids, sc.cpu().numpy()):
                    scores[t] = float(v)
            best_tid, best = max(scores.items(), key=lambda kv: kv[1])
            writer.write(sentences[sid] + "\t" + sentences[best_tid] + "\t"
                         + str(best) + "\n")
            print(index + 1, len(src2dst_dict), end="\r", file=sys.stderr)
    print("\nDone!", file=sys.stderr)


if __name__ == "__main__":
    main()
