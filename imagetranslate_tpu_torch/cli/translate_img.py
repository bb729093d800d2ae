"""Text -> pseudo image grid -> caption decoder translation, three rounds
(port of imagetranslate_tpu/cli/translate_img.py): the same flags and the
same output, ``first ||| second ||| third`` a line (`` ||| source`` added
with ``--verbose``), plus ``--device``.

    python -m imagetranslate_tpu_torch.cli.translate_img --tok TOKDIR \
        --model C2IDIR --caption-model CAPTIONER --input in.txt \
        --output out.txt --src en --target fa [--device cuda]

Each batch of source lines is encoded by Caption2Image into a fake image
grid, and the captioner's beam search decodes the grid (all 49 slots kept)
in the target language; that output goes back through Caption2Image and is
decoded in the source language, and once more in the target language. The
projection + top-k kernel runs in every decode step of a bf16 captioner,
and the decode attention kernel where its config says
``decode_attention_impl="fused"``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("translate_img")
    p.add_argument("--input", dest="input_path", required=True)
    p.add_argument("--src", dest="src_lang", required=True)
    p.add_argument("--target", dest="target_lang", required=True)
    p.add_argument("--output", dest="output_path", required=True)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--tok", dest="tokenizer_path", required=True)
    p.add_argument("--model", dest="model_path", required=True,
                   help="Caption2Image checkpoint")
    p.add_argument("--caption-model", dest="caption_model_path",
                   required=True)
    p.add_argument("--verbose", action="store_true", default=False)
    p.add_argument("--beam", dest="beam_width", type=int, default=4)
    p.add_argument("--max_len_a", type=float, default=1.3)
    p.add_argument("--max_len_b", type=int, default=5)
    p.add_argument("--len-penalty", dest="len_penalty_ratio", type=float,
                   default=0.8)
    p.add_argument("--capacity", dest="total_capacity", type=int, default=150)
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (cuda, cuda:N or cpu)")
    return p


def load_c2i(path: str, device):
    """A Caption2Image checkpoint -> the model on ``device``, in inference
    mode."""
    from imagetranslate_tpu_torch.models.caption2image import Caption2Image
    from imagetranslate_tpu_torch.train.checkpoint import (
        load_config,
        load_params,
    )
    from imagetranslate_tpu_torch.train.weights import CAPTION2IMAGE

    cfg = load_config(path)
    model = Caption2Image(cfg, device=torch.device(device))
    model.load_state_dict(CAPTION2IMAGE.state_dict_from_flax(
        load_params(path), cfg), strict=True)
    return model.eval()


def to_batch(rows, pad: int) -> np.ndarray:
    """Token rows -> [N, bucket_len(longest)] int32, padded."""
    from imagetranslate_tpu_torch.data.loader import bucket_len

    arr = np.full((len(rows), bucket_len(max(len(r) for r in rows))), pad,
                  np.int32)
    for i, r in enumerate(rows):
        arr[i, :len(r)] = r
    return arr


@torch.no_grad()
def translate_rounds(c2i, captioner, b, options, pad: int, eos: int):
    """The three decode rounds of one MTBatch: lists of token rows (each
    starting with its language token, EOS cut)."""
    from imagetranslate_tpu_torch.decoding.beam import (
        beam_search,
        max_len_for,
        trim_outputs,
    )

    device = next(c2i.parameters()).device
    cap_cfg = captioner.cfg

    def dev(a):
        return torch.as_tensor(np.asarray(a)).to(device)

    L = max_len_for(b.src.shape[1], options.max_len_a, options.max_len_b,
                    cap_cfg.max_position_embeddings)
    src_first, tgt_first = b.src[:, 0], b.dst[:, 0]

    def round_(ids, mask, langs, first, out_langs):
        grid = c2i(dev(ids), dev(mask), dev(langs))
        # The captioner's decoder reads the grid in its compute dtype.
        grid = grid.to(cap_cfg.compute_dtype)
        best, lengths = beam_search(
            captioner, grid, torch.ones(grid.shape[:2], dtype=torch.bool,
                                        device=device),
            dev(first), dev(out_langs), None, beam_width=options.beam_width,
            max_len=L, len_penalty_ratio=options.len_penalty_ratio,
            pad_id=pad, eos_id=eos)
        return trim_outputs(best, lengths, remove_first_token=False)

    out1 = round_(b.src, b.src_mask, b.src_langs, tgt_first, b.dst_langs)
    o1 = to_batch(out1, pad)
    out2 = round_(o1, o1 != pad, b.dst_langs, src_first, b.src_langs)
    o2 = to_batch(out2, pad)
    out3 = round_(o2, o2 != pad, b.src_langs, tgt_first, b.dst_langs)
    return out1, out2, out3


def main(argv=None):
    options = get_parser().parse_args(argv)

    from imagetranslate_tpu_torch.cli.caption import load_captioner
    from imagetranslate_tpu_torch.cli.translate import build_batches
    from imagetranslate_tpu_torch.text.processor import TextProcessor

    tp = TextProcessor(options.tokenizer_path)
    pad, eos = tp.pad_token_id(), tp.sep_token_id()
    c2i = load_c2i(options.model_path, options.device)
    captioner = load_captioner(options.caption_model_path, options.device)

    done = 0
    with open(options.output_path, "w") as writer:
        for b in build_batches(options, tp):
            n_real = int(b.row_mask.sum())
            rounds = translate_rounds(c2i, captioner, b, options, pad, eos)
            for i in range(n_real):
                cols = [tp.decode(out[i][1:]) for out in rounds]
                if options.verbose:
                    src_ids = [x for x in b.src[i].tolist() if x != pad][1:]
                    if src_ids and src_ids[-1] == eos:
                        src_ids = src_ids[:-1]
                    cols.append(tp.decode(src_ids))
                writer.write(" ||| ".join(cols) + "\n")
            done += n_real
            print(f"Translated {done}", end="\r", file=sys.stderr)
    print("\nDone!", file=sys.stderr)


if __name__ == "__main__":
    main()
