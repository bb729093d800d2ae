"""The recipe ladder in one command (port of
imagetranslate_tpu/cli/recipe_check.py, the same flags, assertions, ledger
rows and exit codes, plus ``--device``):

1. supervised MT on a two-language sample corpus (``en.txt`` / ``fa.txt``,
   line-aligned, under ``--sample-dir``): tokenizer -> binarize -> ``--steps``
   steps through ``MTTrainer.train_epoch`` -> beam decode -> sacrebleu. The
   dev loss must drop by ``--loss-drop`` and BLEU reach ``--bleu-floor``.
2. UMT: MASS steps, then a reset optimizer schedule and back-translation
   steps between the two languages. The MASS loss must drop, and the
   forced-decode fa->en NLL of a held-out slice must drop by
   ``--bt-nll-drop``.
3. captioning: small random JPEGs with the corpus' English lines as
   captions through ``write_from_list`` -> ``CaptionBatcher`` ->
   ``CaptionTrainer``. The caption loss must drop.

``--ledger FILE`` appends the results as a markdown row. Exit code 0: every
rung passed; 1: one failed (the FAILED row is written first), so a broken
loss scale (``--lr 0``) fails the command.

    python -m imagetranslate_tpu_torch.cli.recipe_check --sample-dir SAMPLE \
        --workdir WORK [--ledger RECIPES.md] [--device cuda]

``make_sample_corpus`` writes a learnable sample corpus (a word-for-word
substitution cipher) where none is at hand.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import datetime
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

# The held-out back-translation dev slice starts past the monolingual head
# that the MASS and back-translation shards are cut from.
MONO_HEAD = 2000


def get_parser():
    p = argparse.ArgumentParser("recipe_check")
    p.add_argument("--sample-dir", default="sample",
                   help="directory of the line-aligned en.txt and fa.txt")
    p.add_argument("--workdir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "recipe_check"))
    p.add_argument("--ledger", default=None,
                   help="append results to this markdown ledger")
    p.add_argument("--vocab", type=int, default=5000)
    p.add_argument("--steps", type=int, default=400,
                   help="supervised MT train steps")
    p.add_argument("--mass-steps", type=int, default=60)
    p.add_argument("--bt-steps", type=int, default=30)
    p.add_argument("--bt-nll-drop", type=float, default=0.02,
                   help="required forced-decode dev-NLL improvement "
                        "(nats/token) across the BT phase")
    p.add_argument("--cap-steps", type=int, default=40)
    p.add_argument("--bleu-floor", type=float, default=0.1,
                   help="sample-scale BLEU floor")
    p.add_argument("--loss-drop", type=float, default=0.5,
                   help="required dev-loss improvement (nats/token)")
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--dev-size", type=int, default=300)
    p.add_argument("--deep", action="store_true",
                   help="2000 supervised steps, 600 MASS + 400 BT steps, "
                        "and a BT-phase BLEU delta beside the NLL gate")
    p.add_argument("--device", default="cuda",
                   help="where the models train (cpu runs the kernels' "
                        "plain versions)")
    return p


def make_sample_corpus(directory: str, n_lines: int = 3000, seed: int = 0,
                       n_words: int = 400, lengths=(3, 14)):
    """Write ``en.txt`` and ``fa.txt`` (line-aligned, ``n_lines`` each):
    English-like sentences of ``lengths`` (the fewest and the most) words
    drawn from a Zipf-like vocabulary of ``n_words`` made-up words, and
    their word-for-word substitution cipher (each word its own foreign word,
    the order kept)."""
    rng = np.random.RandomState(seed)
    letters = "abcdefghijklmnoprstuvwy"

    def words(n):
        out = set()
        while len(out) < n:
            out.add("".join(rng.choice(list(letters), rng.randint(2, 8))))
        return sorted(out)

    en, fa = words(n_words), words(n_words)
    rng.shuffle(fa)
    weight = 1.0 / np.arange(1, n_words + 1)
    weight /= weight.sum()
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "en.txt"), "w") as f_en, \
            open(os.path.join(directory, "fa.txt"), "w") as f_fa:
        for _ in range(n_lines):
            idx = rng.choice(n_words, rng.randint(lengths[0], lengths[1] + 1),
                             p=weight)
            f_en.write(" ".join(en[i] for i in idx) + "\n")
            f_fa.write(" ".join(fa[i] for i in idx) + "\n")


def _cfg(tp):
    from imagetranslate_tpu_torch.models.config import Seq2SeqConfig

    return Seq2SeqConfig(vocab_size=tp.vocab_size(), num_languages=2,
                         hidden_size=256, num_heads=4, intermediate_size=1024,
                         enc_layers=3, dec_layers=2)


@contextlib.contextmanager
def sacrificial(trainer):
    """Steps taken inside leave the trainer's weights, statistics and
    optimizer state as they were (the JAX steps donate a copy)."""
    weights = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    opt_state = copy.deepcopy(trainer.state.opt_state)
    step = trainer.state.step
    try:
        yield
    finally:
        trainer.model.load_state_dict(weights)
        trainer.state.opt_state = opt_state
        trainer.state.step = step


@torch.no_grad()
def dev_loss(trainer, batches) -> float:
    """Mean label-smoothed dev loss per token over fixed batches."""
    from imagetranslate_tpu_torch.ops.losses import smoothed_nll_loss
    from imagetranslate_tpu_torch.train.step import mt_batch_to_device

    total = n = 0.0
    for b in batches:
        d = mt_batch_to_device(b, trainer.device)
        logits = trainer.model(d["src"], d["src_mask"], d["dst"],
                               d["dst_mask"], d["src_langs"], d["dst_langs"])
        mask = d["dst_mask"][:, 1:] & d["row_mask"][:, None]
        sl, nt = smoothed_nll_loss(logits, d["dst"][:, 1:], mask)
        total += float(sl)
        n += float(nt)
    return total / max(n, 1.0)


def _split(src_path, dst_path, ranges):
    """Write the lines [lo, hi) of a source file to each (path, lo, hi)."""
    with open(src_path) as r:
        lines = r.readlines()
    for path, lo, hi in ranges:
        with open(dst_path(path), "w") as w:
            w.writelines(lines[lo:hi])


def run_supervised(options, tp, results):
    from imagetranslate_tpu_torch.data.binarize import load_mt, write_mt
    from imagetranslate_tpu_torch.data.loader import MTBatcher
    from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer

    wd, k = options.workdir, options.dev_size
    for lang in ("fa", "en"):
        _split(os.path.join(options.sample_dir, f"{lang}.txt"),
               lambda name: os.path.join(wd, f"{name}.{lang}"),
               [("dev", 0, k), ("train", k, None)])
    mt_bin, dev_bin = os.path.join(wd, "train.mt"), os.path.join(wd, "dev.mt")
    n_train = write_mt(tp, mt_bin, os.path.join(wd, "train.fa"),
                       tp.token_id("<fa>"), os.path.join(wd, "train.en"),
                       tp.token_id("<en>"))
    n_dev = write_mt(tp, dev_bin, os.path.join(wd, "dev.fa"),
                     tp.token_id("<fa>"), os.path.join(wd, "dev.en"),
                     tp.token_id("<en>"))
    print(f"[recipes] supervised: {n_train} train / {n_dev} dev pairs",
          flush=True)

    trainer = MTTrainer(_cfg(tp), tp, lr=options.lr, warmup=100,
                        device=options.device)
    batcher = MTBatcher(load_mt(mt_bin), pad_id=tp.pad_token_id())
    dev_batcher = MTBatcher(load_mt(dev_bin), pad_id=tp.pad_token_id())

    loss0 = dev_loss(trainer, dev_batcher.batches)
    t0 = time.time()
    step = epoch = 0
    while step < options.steps:
        step = trainer.train_epoch(
            step, os.path.join(wd, "mt_ckpt"), mt_batcher=batcher,
            max_step=options.steps, eval_every=10 ** 9, save_every=10 ** 9,
            epoch_seed=epoch)
        epoch += 1
    loss1 = dev_loss(trainer, dev_batcher.batches)
    bleu = trainer.eval_bleu(dev_batcher, os.path.join(wd, "mt_ckpt"))
    results["supervised"] = {
        "steps": step, "dev_loss_before": round(loss0, 4),
        "dev_loss_after": round(loss1, 4), "bleu": round(bleu, 3),
        "seconds": round(time.time() - t0, 1),
    }
    assert loss1 < loss0 - options.loss_drop, (
        f"supervised dev loss did not drop: {loss0:.3f} -> {loss1:.3f}")
    assert bleu >= options.bleu_floor, (
        f"BLEU {bleu:.3f} below floor {options.bleu_floor}")
    return trainer


def run_umt(options, tp, results):
    from imagetranslate_tpu_torch.data.binarize import (
        load_mass,
        load_mt,
        write_mt,
    )
    from imagetranslate_tpu_torch.data.loader import MassBatcher, MTBatcher
    from imagetranslate_tpu_torch.train.step import mass_batch_to_device
    from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer

    wd = options.workdir
    examples = []
    for lang in ("en", "fa"):
        src = os.path.join(wd, f"mono.{lang}")
        _split(os.path.join(options.sample_dir, f"{lang}.txt"),
               lambda _: src, [(None, 0, MONO_HEAD)])
        out = os.path.join(wd, f"mass.{lang}")
        write_mt(tp, out, src, tp.token_id(f"<{lang}>"))
        examples.extend(load_mass(out))
    trainer = MTTrainer(_cfg(tp), tp, lr=options.lr, warmup=50,
                        bt_beam_width=1, device=options.device)
    batcher = MassBatcher(examples, pad_id=tp.pad_token_id())
    probe = batcher.batches[:8]

    def mass_probe_loss():
        total = n = 0.0
        rng = torch.Generator().manual_seed(0)
        with sacrificial(trainer):
            for b in probe:
                trainer.state, m = trainer.mass_step(
                    trainer.state, mass_batch_to_device(b, trainer.device),
                    rng)
                total += float(m["sum_loss"])
                n += float(m["ntokens"])
        return total / max(n, 1.0)

    # Phase 1: MASS, the loss read on the head of the stream before and
    # after.
    m0 = mass_probe_loss()
    step = epoch = 0
    while step < options.mass_steps:
        step = trainer.train_epoch(
            step, os.path.join(wd, "umt_ckpt"), mass_batcher=batcher,
            max_step=options.mass_steps, eval_every=10 ** 9,
            save_every=10 ** 9, epoch_seed=epoch)
        epoch += 1
    m1 = mass_probe_loss()

    # The quality signal of back-translation: forced-decode NLL on a
    # held-out fa->en slice past the monolingual head (the sample corpus is
    # line-aligned).
    hi = MONO_HEAD + min(options.dev_size, 128)
    for lang in ("fa", "en"):
        _split(os.path.join(options.sample_dir, f"{lang}.txt"),
               lambda _: os.path.join(wd, f"btdev.{lang}"),
               [(None, MONO_HEAD, hi)])
    bt_dev_bin = os.path.join(wd, "btdev.mt")
    write_mt(tp, bt_dev_bin, os.path.join(wd, "btdev.fa"),
             tp.token_id("<fa>"), os.path.join(wd, "btdev.en"),
             tp.token_id("<en>"))
    bt_dev_batcher = MTBatcher(load_mt(bt_dev_bin), pad_id=tp.pad_token_id())
    bt_dev = bt_dev_batcher.batches[:6]
    nll0 = dev_loss(trainer, bt_dev)
    bleu0 = bleu1 = None
    if options.deep:
        bleu0 = trainer.eval_bleu(bt_dev_batcher,
                                  os.path.join(wd, "umt_bleu0"))

    # Phase 2: the schedule reset, back-translation between the languages.
    trainer.reset_for_finetune()
    directions = MTTrainer.lang_directions(["en", "fa"], tp)
    bt_target = step + options.bt_steps
    epoch = 99
    while step < bt_target:
        step = trainer.train_epoch(
            step, os.path.join(wd, "umt_ckpt"), mass_batcher=batcher,
            max_step=bt_target, fine_tune=True, lang_directions=directions,
            eval_every=10 ** 9, save_every=10 ** 9, epoch_seed=epoch)
        epoch += 1
    nll1 = dev_loss(trainer, bt_dev)
    if options.deep:
        bleu1 = trainer.eval_bleu(bt_dev_batcher,
                                  os.path.join(wd, "umt_bleu1"))

    results["umt"] = {
        "mass_steps": options.mass_steps,
        "bt_steps": step - options.mass_steps,
        "mass_loss_before": round(m0, 4), "mass_loss_after": round(m1, 4),
        "bt_dev_nll_before": round(nll0, 4),
        "bt_dev_nll_after": round(nll1, 4),
    }
    if options.deep:
        results["umt"]["bt_bleu_before"] = round(bleu0, 3)
        results["umt"]["bt_bleu_after"] = round(bleu1, 3)
        results["umt"]["deep"] = True
    assert m1 < m0 - 0.2, f"MASS loss did not drop: {m0:.3f} -> {m1:.3f}"
    assert step >= bt_target, "BT phase did not step"
    assert nll1 < nll0 - options.bt_nll_drop, (
        f"BT phase did not improve fa->en dev NLL: {nll0:.3f} -> {nll1:.3f}")


def run_caption(options, tp, results):
    from PIL import Image

    from imagetranslate_tpu_torch.data.binarize_captions import (
        write_from_list,
    )
    from imagetranslate_tpu_torch.data.images import CaptionBatcher
    from imagetranslate_tpu_torch.train.step import caption_batch_to_device
    from imagetranslate_tpu_torch.train.trainer_caption import CaptionTrainer

    wd = options.workdir
    img_dir = os.path.join(wd, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    rs = np.random.RandomState(0)
    with open(os.path.join(options.sample_dir, "en.txt")) as r:
        caps = [line.strip() for _, line in zip(range(48), r)]
    tsv = os.path.join(wd, "caps.tsv")
    with open(tsv, "w") as w:
        for i, c in enumerate(caps):
            name = f"{i:03d}.jpg"
            Image.fromarray(rs.randint(0, 255, (96, 96, 3), np.uint8)).save(
                os.path.join(img_dir, name))
            w.write(f"{name}\t{c}\n")
    cap_bin = os.path.join(wd, "caps.bin")
    write_from_list(tp, cap_bin, tsv, lang="en")

    trainer = CaptionTrainer(_cfg(tp), tp, lr=options.lr, warmup=20,
                             img_size=96, device=options.device)
    batcher = CaptionBatcher(cap_bin, tp)

    def cap_probe_loss():
        total = n = 0.0
        rng = torch.Generator().manual_seed(0)
        with sacrificial(trainer):
            for b in batcher.batches[:4]:
                batch = caption_batch_to_device(
                    b, b.images(img_dir, size=96), trainer.device)
                trainer.state, m = trainer.cap_step(trainer.state, batch,
                                                    rng)
                total += float(m["sum_loss"])
                n += float(m["ntokens"])
        return total / max(n, 1.0)

    c0 = cap_probe_loss()
    step = epoch = 0
    while step < options.cap_steps:
        step = trainer.train_epoch(
            step, os.path.join(wd, "cap_ckpt"), batcher, image_root=img_dir,
            max_step=options.cap_steps, eval_every=10 ** 9,
            save_every=10 ** 9, epoch_seed=epoch)
        epoch += 1
    c1 = cap_probe_loss()
    results["caption"] = {"steps": step, "loss_before": round(c0, 4),
                          "loss_after": round(c1, 4)}
    assert c1 < c0 - 0.3, f"caption loss did not drop: {c0:.3f} -> {c1:.3f}"


def device_name(device: str) -> str:
    """The ledger's device string: the card's name, or the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


def append_ledger(path, results, ok: bool, device: str):
    stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M")
    lines = [f"\n## {stamp} — {'PASS' if ok else 'FAIL'} "
             f"({device_name(device)})\n"]
    for name, r in results.items():
        lines.append(f"- **{name}**: "
                     + ", ".join(f"{k}={v}" for k, v in r.items()) + "\n")
    with open(path, "a") as w:
        w.writelines(lines)


def main(argv=None):
    options = get_parser().parse_args(argv)
    if options.deep:
        options.steps = max(options.steps, 2000)
        options.mass_steps = max(options.mass_steps, 600)
        options.bt_steps = max(options.bt_steps, 400)
    os.makedirs(options.workdir, exist_ok=True)

    from imagetranslate_tpu_torch.text.processor import TextProcessor

    tok_dir = os.path.join(options.workdir, "tok")
    if not os.path.exists(os.path.join(tok_dir, "vocab.json")):
        os.makedirs(tok_dir, exist_ok=True)
        TextProcessor().train_tokenizer(
            [os.path.join(options.sample_dir, f) for f in
             ("en.txt", "fa.txt")],
            options.vocab, tok_dir, languages={"<en>": 0, "<fa>": 1})
    tp = TextProcessor(tok_dir)

    results = {}
    ok = True
    try:
        run_supervised(options, tp, results)
        print(f"[recipes] supervised OK: {results['supervised']}", flush=True)
        run_umt(options, tp, results)
        print(f"[recipes] umt OK: {results['umt']}", flush=True)
        run_caption(options, tp, results)
        print(f"[recipes] caption OK: {results['caption']}", flush=True)
    except Exception as e:  # any failure = red ladder, recorded in the ledger
        ok = False
        results.setdefault("failure", {})["message"] = (
            f"{type(e).__name__}: {e}")
        import traceback

        traceback.print_exc()
        print(f"[recipes] FAILED: {e}", file=sys.stderr, flush=True)
    if options.ledger:
        append_ledger(options.ledger, results, ok, options.device)
    print(json.dumps({"ok": ok, **results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
