"""SenSim cosine of every parallel pair as TSV lines ``src<TAB>tgt<TAB>sim``
(port of imagetranslate_tpu/cli/get_sen_sim.py): the same flags and the
same output, plus ``--device``.

    python -m imagetranslate_tpu_torch.cli.get_sen_sim --tok TOKDIR \
        --model SENSIMDIR --dev_mt pairs.mt --output sims.tsv [--device cuda]
"""

from __future__ import annotations

import argparse
import sys


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("get_sen_sim")
    p.add_argument("--tok", dest="tokenizer_path", required=True)
    p.add_argument("--model", dest="model_path", required=True)
    p.add_argument("--dev_mt", dest="mt_dev_path", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--batch", type=int, default=20000)
    p.add_argument("--capacity", dest="total_capacity", type=int, default=600)
    p.add_argument("--device", default="cuda",
                   help="torch device to score on (cuda, cuda:N or cpu)")
    return p


def main(argv=None):
    options = get_parser().parse_args(argv)

    import torch

    from imagetranslate_tpu_torch.data.binarize import load_mt
    from imagetranslate_tpu_torch.data.loader import MTBatcher
    from imagetranslate_tpu_torch.models.sensim import SenSim
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train.checkpoint import (
        load_config,
        load_params,
    )
    from imagetranslate_tpu_torch.train.weights import SENSIM

    tp = TextProcessor(options.tokenizer_path)
    cfg = load_config(options.model_path)
    device = torch.device(options.device)
    model = SenSim(cfg, device=device)
    model.load_state_dict(SENSIM.state_dict_from_flax(
        load_params(options.model_path), cfg), strict=True)
    model.eval()

    pad = tp.pad_token_id()
    batcher = MTBatcher(load_mt(options.mt_dev_path), pad_id=pad,
                        max_batch=options.batch // 8,
                        capacity_mb=options.total_capacity)

    def detok(row):
        ids = [t for t in row.tolist() if t != pad][1:]
        if ids and ids[-1] == tp.sep_token_id():
            ids = ids[:-1]
        return tp.decode(ids)

    def dev(a):
        return torch.as_tensor(a).to(device)

    with open(options.output, "w") as w, torch.no_grad():
        for i, b in enumerate(batcher):
            sims = model.similarity(
                dev(b.src), dev(b.src_mask), dev(b.src_langs), dev(b.dst),
                dev(b.dst_mask), dev(b.dst_langs)).cpu().tolist()
            for r in range(int(b.row_mask.sum())):
                w.write(detok(b.src[r]) + "\t" + detok(b.dst[r]) + "\t"
                        + str(sims[r]) + "\n")
            print(f"{i + 1}/{len(batcher)}", end="\r", file=sys.stderr)
    print("\nDone!", file=sys.stderr)


if __name__ == "__main__":
    main()
