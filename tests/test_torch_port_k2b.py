"""K2b, the vocab-sharded projection + top-k of the tensor-parallel decode,
against the JAX package's ``sharded_project_topk``.

JAX runs its kernel in interpret mode inside ``shard_map`` over four model
shards of the conftest's virtual CPU devices, exactly as
tests/test_topk_project.py runs it; the port runs ``sharded_project_topk``
on four spawned ranks joined over gloo (K2's plain version per shard, the
index shift, the gathers, ``merge_shard_topk_reference``). Both weight
layouts, an untied (sharded) and a tied (replicated, sliced) bias, with
columns 77, 333 and 450 made equal so that ties straddle the shard
boundaries, and a row whose logits are all equal. Indices exact, values
within 1e-6, lse within 1e-5 (the two sum the shard lses in other orders).

The merge kernel ``itt_topk_merge`` is held against its plain version in
the ``cuda``-marked test, which skips without a card; ``chip_smoke.py``
phase 25 runs the same checks on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.ops import topk_project as jtkp
from imagetranslate_tpu_torch.ops import topk_project as tkp
from imagetranslate_tpu_torch.parallel.spawn import run_ranks

import _torch_port_ranks as ranks

M, E, V, K = 16, 128, 512, 4


def _inputs(seed, layout, bias):
    """Row 5 is zero: its logits are the bias, all equal with a zero one."""
    rng = np.random.RandomState(seed)
    h = rng.randn(M, E).astype(np.float32)
    w = (rng.randn(V, E) * 0.05).astype(np.float32)       # [V, E]
    b = (rng.randn(V) if bias else np.zeros(V)).astype(np.float32)
    w[77] = w[450] = w[333]                               # cross-shard ties
    b[77] = b[450] = b[333]
    h[5] = 0.0
    wj = w if layout == "ve" else np.ascontiguousarray(w.T)
    return h, w, b, wj


def _jax_k2b(h, wj, b, layout, n):
    from jax.sharding import Mesh, PartitionSpec as P

    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    mesh = Mesh(np.array(jax.devices()[:n]).reshape(1, n), ("data", "model"))
    fn = shard_map(
        lambda hh, ww, bb: jtkp.sharded_project_topk(
            hh, ww, bb, K, w_layout=layout, interpret=True),
        mesh=mesh,
        in_specs=(P("data", None),
                  P("model", None) if layout == "ve" else P(None, "model"),
                  P("model")),
        out_specs=(P("data", None), P("data", None), P("data")),
        check_vma=False)
    return [np.asarray(a) for a in fn(jnp.asarray(h), jnp.asarray(wj),
                                      jnp.asarray(b))]


CASES = [("ve", True), ("ev", False)]


@pytest.fixture(scope="module")
def port_k2b(tmp_path_factory):
    """The port's triples for every case, from one spawn of four ranks
    (each rank's list)."""
    inputs = [_inputs(3, layout, bias)[:3] for layout, bias in CASES]
    store = tmp_path_factory.mktemp("k2b") / "store"
    return run_ranks(ranks.k2b, 4, str(store), (inputs, K))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_k2b_matches_jax_sharded_project_topk(port_k2b, case):
    layout, bias = CASES[case]
    h, w, b, wj = _inputs(3, layout, bias)
    want = _jax_k2b(h, wj, b, layout, 4)
    # Every rank returns the same merged triple.
    for per_rank in port_k2b:
        val, idx, lse = per_rank[case]
        np.testing.assert_array_equal(idx, want[1])
        np.testing.assert_allclose(val, want[0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(lse, want[2], rtol=0, atol=1e-5)
    # Row 5: the bias's order, the lowest index first among equals.
    assert want[1][5].tolist() == np.argsort(-b, kind="stable")[:K].tolist()


def test_merge_reference_keeps_the_shard_major_tie_order():
    """Equal values in every shard: the merge lists them by ascending
    global index (shard-major), as lax.top_k over the concatenation."""
    vals = torch.zeros((3, 2, 4))
    idxs = (torch.arange(3)[:, None, None] * 100
            + torch.arange(4)[None, None, :]).expand(3, 2, 4).int()
    lses = torch.tensor([[0.0, 1.0], [2.0, 3.0], [-1.0, 0.5]])
    val, idx, lse = tkp.merge_shard_topk_reference(vals, idxs, lses, 6)
    assert idx.tolist() == [[0, 1, 2, 3, 100, 101]] * 2
    torch.testing.assert_close(lse, torch.logsumexp(lses, 0))
    got = tkp.merge_shard_topk(vals, idxs.contiguous(), lses, 6)  # CPU
    assert got[1].tolist() == idx.tolist()


@pytest.mark.cuda
def test_cuda_merge_matches_plain():
    """itt_topk_merge against merge_shard_topk_reference on gathered
    shard triples, ties across shards and ragged M included; and K2 over
    column slices + the merge against K2 over the whole vocab."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, m, k in ((2, 256, 4), (4, 256, 4), (4, 100, 16), (4, 1, 1),
                    (3, 7, 8)):
        vals = torch.randn(n, m, k, generator=gen, device="cuda")
        vals = vals.sort(dim=-1, descending=True).values.contiguous()
        vals[:, : m // 2] = vals[:, : m // 2].round()     # many ties
        vals = vals.sort(dim=-1, descending=True).values.contiguous()
        idxs = (torch.arange(n, device="cuda")[:, None, None] * 1000
                + torch.arange(k, device="cuda")[None, None, :]
                ).expand(n, m, k).int().contiguous()
        lses = torch.randn(n, m, generator=gen, device="cuda")
        got = tkp.merge_shard_topk(vals, idxs, lses, k)
        want = tkp.merge_shard_topk_reference(vals, idxs, lses, k)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-5)
    V, Ek, m, k, n = 32000, 768, 256, 4, 4
    h = torch.randn(m, Ek, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(V, Ek, generator=gen, device="cuda") * 0.05).bfloat16()
    b = torch.randn(V, generator=gen, device="cuda") * 0.1
    full = tkp.project_topk(h, w, b, k)
    parts = [tkp.project_topk(h, wi.contiguous(), bi.contiguous(), k)
             for wi, bi in zip(w.chunk(n), b.chunk(n))]
    vals = torch.stack([p[0] for p in parts])
    idxs = torch.stack([p[1] + i * (V // n) for i, p in enumerate(parts)])
    lses = torch.stack([p[2] for p in parts])
    got = tkp.merge_shard_topk(vals, idxs.int().contiguous(), lses, k)
    torch.cuda.synchronize()
    assert torch.equal(got[1], full[1]) and torch.equal(got[0], full[0])
    torch.testing.assert_close(got[2], full[2], rtol=0, atol=1e-5)
