"""The benchmark's frozen arithmetic: the card's published peaks, the least
time of each hand-written kernel at a call's shapes (its roofline bound), and
the model FLOP counts that the ``mfu.*`` metrics divide by.

The kernel bounds are copies of ``chip_smoke.py``'s, frozen here so that a
later change to the program or to the smoke cannot move the yardstick:

- ``bound``: chip_smoke.py:519 (the larger of bytes over the memory rate and
  operations over the compute rate);
- ``k1_forward`` / ``k1_backward``: chip_smoke.py:1276-1287 (the function's
  own traffic: q, k, v, the bias and the row statistics; the keep bits and
  the backward's read of the output are the design's, not the function's);
- ``k5_forward`` / ``k5_backward``: chip_smoke.py:1586-1589 (fp32 logits
  read once, dx written once; fp32 operations outside the tensor cores);
- ``k2``: chip_smoke.py:597 ``topk_bound``;
- ``k4``: chip_smoke.py:3283 ``k4_bound``.

Each returns seconds. Peaks: NVIDIA's H100 SXM data sheet, dense rates at
the card's full 700 W power limit; a share is stated against them with the
card's name and ``power.limit`` beside it (``card_note``).
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
BF16_FLOPS_PER_S = 989e12     # dense bf16 on the tensor cores, published
FP32_FLOPS_PER_S = 67e12      # fp32 outside the tensor cores, published


def bound(nbytes: float, flops: float,
          flops_per_s: float = BF16_FLOPS_PER_S) -> float:
    """The least seconds the card could take to move ``nbytes`` and do
    ``flops`` operations."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)


def k1_forward(B: int, T: int, S: int, H: int, D: int,
               bias_rows: int) -> float:
    """K1's forward (bf16 q, k, v; fp32 bias [B, 1, bias_rows, S])."""
    elems = B * H * D
    return bound(2 * elems * (2 * T + 2 * S) + 4 * B * bias_rows * S
                 + 8 * B * H * T, 4.0 * B * H * T * S * D)


def k1_backward(B: int, T: int, S: int, H: int, D: int,
                bias_rows: int) -> float:
    """K1's backward without dbias."""
    elems = B * H * D
    return bound(2 * elems * (3 * T + 4 * S) + 4 * B * bias_rows * S
                 + 8 * B * H * T, 10.0 * B * H * T * S * D)


def k5_forward(N: int, V: int, itemsize: int = 4) -> float:
    """K5's forward over N rows of V logits."""
    return bound(N * V * itemsize + N * 16, 7.0 * N * V, FP32_FLOPS_PER_S)


def k5_backward(N: int, V: int, itemsize: int = 4) -> float:
    return bound(N * V * 2 * itemsize + N * 16, 6.0 * N * V,
                 FP32_FLOPS_PER_S)


def k2(M: int, k: int, E: int, V: int) -> float:
    """K2 (both launches): h, W and the bias read once, the outputs written
    once, 2 M E V operations on the bf16 tensor cores."""
    return bound(M * E * 2 + V * E * 2 + V * 4 + M * (8 * k + 4),
                 2.0 * M * E * V)


def k4(R: int, H: int, D: int, n: int) -> float:
    """K4 at ``n`` live positions: each live K and V line read once, q read
    and ctx written once, bf16; 4 operations a (position, channel)."""
    return bound((2 * R * n * H * D + 2 * R * H * D) * 2,
                 4.0 * R * n * H * D)


# ---------------- model FLOPs (for the mfu.* metrics) ----------------

def encoder_layer_params(E: int, F: int) -> int:
    """Matmul parameters of one encoder layer: Q, K, V, O and the FFN."""
    return 4 * E * E + 2 * E * F


def decoder_layer_params(E: int, F: int) -> int:
    """Self-attention's Q, K, V, O, cross-attention's Q, K, V, O, FFN."""
    return 8 * E * E + 2 * E * F


def train_flops(cfg: dict, src_tokens: int, tgt_tokens: int,
                attn_pairs: int) -> float:
    """Model FLOPs of one training step (forward and backward: 6 per
    parameter and token; 3 x 4 E per attended pair and layer). The encoder
    counts the real source tokens, the decoder and the projection the real
    target tokens the loss reads; ``attn_pairs``: the (query, key) pairs
    that attention keeps inside the examples, summed over the encoder's
    self-attention (once, times the encoder layers: see
    ``train_attn_pairs``) and the decoder's. Recompute is not counted."""
    E, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    dense = (6.0 * cfg["enc_layers"] * encoder_layer_params(E, F)
             * src_tokens
             + 6.0 * (cfg["dec_layers"] * decoder_layer_params(E, F) + V * E)
             * tgt_tokens)
    return dense + 3.0 * 4.0 * E * attn_pairs


def train_attn_pairs(cfg: dict, src_lens, tgt_lens) -> int:
    """The attended (query, key) pairs of a batch's examples, summed over
    the layers: the encoder's s^2, the decoder's causal t (t + 1) / 2 and
    its cross-attention's t s, with t the decoder positions of an example
    (its target length less one) and s its source length."""
    pairs = 0
    for s, t in zip(src_lens, tgt_lens):
        t = max(int(t) - 1, 0)
        pairs += (cfg["enc_layers"] * s * s
                  + cfg["dec_layers"] * (t * (t + 1) // 2 + t * s))
    return pairs


def encode_flops(cfg: dict, src_lens) -> float:
    """Forward FLOPs of the text encoder over the real source tokens."""
    E, F = cfg["hidden_size"], cfg["intermediate_size"]
    per = 2.0 * encoder_layer_params(E, F)
    return sum(cfg["enc_layers"] * (per * s + 4.0 * E * s * s)
               for s in src_lens)


def resnet_flops(depth_blocks=(2, 2, 2, 2), img: int = 224,
                 embed_dim: int = 768) -> float:
    """Forward FLOPs of one image through the ResNet-18 grid encoder: every
    convolution's 2 Cin Cout k^2 Hout Wout, and the grid's fc."""
    def conv(cin, cout, k, hw):
        return 2.0 * cin * cout * k * k * hw * hw

    hw = img // 2
    total = conv(3, 64, 7, hw)
    hw //= 2                         # max pool
    cin = 64
    for stage, blocks in enumerate(depth_blocks):
        cout = 64 * 2 ** stage
        for j in range(blocks):
            if stage > 0 and j == 0:
                hw //= 2
                total += conv(cin, cout, 1, hw)     # downsample
            total += conv(cin, cout, 3, hw) + conv(cout, cout, 3, hw)
            cin = cout
    return total + 2.0 * cin * embed_dim * hw * hw


def decode_step_flops(cfg: dict, live: int, src_len: int) -> float:
    """FLOPs of one decode step for one beam row: every decoder layer's
    self-attention projections, the cross-attention's query and output, the
    FFN, attention over ``live`` cached positions and ``src_len`` encoder
    states, then the vocabulary projection."""
    E, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    per_layer = (2.0 * (6 * E * E + 2 * E * F)
                 + 4.0 * E * live + 4.0 * E * src_len)
    return cfg["dec_layers"] * per_layer + 2.0 * V * E


def cross_kv_flops(cfg: dict, src_len: int) -> float:
    """The cross-attention's K and V projections of one source row, once
    per decoder layer."""
    E = cfg["hidden_size"]
    return cfg["dec_layers"] * 2.0 * 2.0 * E * E * src_len


def card_note() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
