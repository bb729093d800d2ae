"""Tiny cells for the CPU tests: the cells' own code and references at
widths a test run holds (every width cut, every mechanism kept)."""

import copy

import harness

TINY_MODEL = dict(vocab_size=96, hidden_size=32, num_heads=4,
                  intermediate_size=64, max_position_embeddings=64,
                  enc_layers=2, dec_layers=2, img_size=64,
                  dtype="float32", kv_cache_dtype="float32")
TINY_TRAFFIC = {
    "mt-train-packed": dict(pairs=60, rows=4, row_tokens=32,
                            max_seq_len=30, label_steps=2, warm_steps=1,
                            length={"median": 8, "sigma": 0.5, "min": 4,
                                    "max": 30}),
    "mt-train-bucketed": dict(pairs=60, batch=400, capacity=600,
                              max_seq_len=30, label_steps=2, warm_steps=1,
                              length={"median": 8, "sigma": 0.5, "min": 4,
                                      "max": 30}),
    "mt-translate-beam4": dict(corpus_sentences=48, pass_batches=3, batch=400,
                               length={"median": 8, "sigma": 0.5, "min": 4,
                                       "max": 30}, check_rows=4),
    "caption-beam4": dict(batch=16, max_len=16, check_rows=16),
}
# The control needs rounding to show at tiny widths: bf16 compute and a
# wider model in training, logits spread as the full model's (std ~0.5)
# in decoding.
TINY_CONTROL = {
    "mt-train-packed": dict(hidden_size=64, intermediate_size=128,
                            dtype="bfloat16", kv_cache_dtype="bfloat16"),
    "mt-train-bucketed": dict(hidden_size=64, intermediate_size=128,
                              dtype="bfloat16", kv_cache_dtype="bfloat16"),
    "mt-translate-beam4": dict(initializer_range=0.1),
    "caption-beam4": dict(initializer_range=0.1),
}


def tiny_cell(name: str) -> harness.Cell:
    cell = copy.deepcopy(harness.load_cell(name))
    cell.config.update(TINY_MODEL)
    cell.traffic.update(TINY_TRAFFIC[name])
    return cell
