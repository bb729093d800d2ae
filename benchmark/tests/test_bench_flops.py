"""The frozen arithmetic against counts made by hand at two shapes each, and
against the smoke's functions it was copied from."""

import math

import pytest

import flops

BW, FL = flops.HBM_BYTES_PER_S, flops.BF16_FLOPS_PER_S


def test_bound_takes_the_larger():
    assert flops.bound(3.35e12, 0.0) == 1.0
    assert flops.bound(0.0, 989e12) == 1.0
    assert flops.bound(3.35e12, 2 * 989e12) == 2.0


@pytest.mark.parametrize("B,T,S,H,D,rows", [(2, 3, 5, 1, 4, 1),
                                            (64, 256, 256, 12, 64, 256)])
def test_k1(B, T, S, H, D, rows):
    # q, k, v, out bf16; bias fp32; two fp32 statistics a row.
    fwd_bytes = 2 * (B * T * H * D * 2 + B * S * H * D * 2) \
        + 4 * B * rows * S + 8 * B * H * T
    bwd_bytes = 2 * (B * T * H * D * 3 + B * S * H * D * 4) \
        + 4 * B * rows * S + 8 * B * H * T
    assert math.isclose(flops.k1_forward(B, T, S, H, D, rows),
                        max(fwd_bytes / BW, 2 * 2 * B * H * T * S * D / FL))
    assert math.isclose(flops.k1_backward(B, T, S, H, D, rows),
                        max(bwd_bytes / BW, 5 * 2 * B * H * T * S * D / FL))


@pytest.mark.parametrize("N,V", [(3, 7), (16320, 32000)])
def test_k5(N, V):
    assert math.isclose(flops.k5_forward(N, V),
                        max((4 * N * V + 16 * N) / BW, 7 * N * V / 67e12))
    assert math.isclose(flops.k5_backward(N, V),
                        max((8 * N * V + 16 * N) / BW, 6 * N * V / 67e12))


@pytest.mark.parametrize("M,k,E,V", [(4, 1, 8, 16), (6144, 4, 768, 32000)])
def test_k2(M, k, E, V):
    nbytes = 2 * M * E + 2 * V * E + 4 * V + M * k * 8 + M * 4
    assert math.isclose(flops.k2(M, k, E, V),
                        max(nbytes / BW, 2 * M * E * V / FL))


@pytest.mark.parametrize("R,H,D,n", [(2, 1, 8, 3), (6144, 12, 64, 31)])
def test_k4(R, H, D, n):
    nbytes = 2 * (2 * R * n * H * D + 2 * R * H * D)
    assert math.isclose(flops.k4(R, H, D, n),
                        max(nbytes / BW, 4 * R * n * H * D / FL))


def test_copies_match_the_smoke():
    import chip_smoke as cs

    assert math.isclose(1e-3 * cs.topk_bound(256, 4)[0],
                        flops.k2(256, 4, 768, 32000))
    assert math.isclose(1e-3 * cs.k4_bound(768, 12, 64, 32)[0],
                        flops.k4(768, 12, 64, 32))
    assert math.isclose(1e-3 * cs.bound(10.0, 20.0)[0],
                        flops.bound(10.0, 20.0))


CFG = dict(hidden_size=768, intermediate_size=3072, vocab_size=32000,
           enc_layers=6, dec_layers=6)


@pytest.mark.parametrize("src,tgt", [((3,), (4,)), ((10, 20), (12, 18))])
def test_train_flops(src, tgt):
    E, F, V = 768, 3072, 32000
    enc = 4 * E * E + 2 * E * F
    dec = 8 * E * E + 2 * E * F
    pairs = sum(6 * s * s + 6 * ((t - 1) * t // 2 + (t - 1) * s)
                for s, t in zip(src, tgt))
    assert flops.train_attn_pairs(CFG, src, tgt) == pairs
    n_src, n_tgt = sum(src), sum(t - 1 for t in tgt)
    want = (6 * 6 * enc * n_src + 6 * (6 * dec + V * E) * n_tgt
            + 12 * E * pairs)
    assert math.isclose(flops.train_flops(CFG, n_src, n_tgt, pairs), want)


def test_resnet18_flops():
    # ResNet-18 at 224: 1.814 G multiply-adds in its convolutions
    # (torchvision's count), then the grid's fc over 49 slots.
    got = flops.resnet_flops()
    assert math.isclose(got - 2 * 512 * 768 * 49, 2 * 1.814e9, rel_tol=2e-3)
    assert math.isclose(flops.resnet_flops(img=64, embed_dim=32),
                        (got - 2 * 512 * 768 * 49) / (224 / 64) ** 2
                        + 2 * 512 * 32 * 4, rel_tol=0.05)


@pytest.mark.parametrize("live,src", [(1, 3), (31, 49)])
def test_decode_step_flops(live, src):
    E, F, V = 768, 3072, 32000
    per_layer = 2 * (4 * E * E + 2 * E * E + 2 * E * F) + 4 * E * (live + src)
    assert math.isclose(flops.decode_step_flops(CFG, live, src),
                        6 * per_layer + 2 * V * E)
    assert flops.cross_kv_flops(CFG, src) == 6 * 4 * E * E * src
