"""The port's projection + top-k + logsumexp against the JAX package.

``imagetranslate_tpu_torch.ops.topk_project.project_topk_reference`` (the plain
PyTorch version the CPU runs, and the one the CUDA kernel is held against)
must give the JAX kernel's triple on every case of tests/test_topk_project.py:
the Pallas kernel in interpret mode and ``reference_topk``, inputs made from a
numpy seed. Values atol 1e-5; lse rtol 1e-6 / atol 1e-5. The three programs
sum their fp32 products in different orders, so two candidates closer than
that rounding noise may swap places: on random inputs the indices must name
logits equal to the returned values (held against an fp64 product) and must
equal the JAX indices wherever the neighbouring candidates are further apart
than the tolerance; the tie cases use exactly representable inputs and stay
exact. The CUDA kernel itself is compared with the plain version in the ``cuda``-marked
test, which skips without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.ops import topk_project as jtkp
from imagetranslate_tpu_torch.ops import topk_project as tkp


def _torch(x):
    """jax/numpy array -> torch tensor with the same values and dtype."""
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.tensor(x.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(x)


TOL = 1e-5


def _assert_triple(got, want, logits64=None):
    """``logits64``: the fp64 logits of the same inputs. Given, indices are
    compared where rounding cannot reorder them; absent (exactly
    representable inputs), they must be equal everywhere."""
    val, idx, lse = got
    rval, ridx, rlse = (np.asarray(a) for a in want)
    np.testing.assert_allclose(val.numpy(), rval, rtol=0, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), rlse, rtol=1e-6, atol=TOL)
    if logits64 is None:
        np.testing.assert_array_equal(idx.numpy(), ridx)
        return
    k = idx.shape[1]
    at_idx = np.take_along_axis(logits64, idx.numpy().astype(np.int64), 1)
    np.testing.assert_allclose(at_idx, val.numpy(), rtol=0, atol=TOL)
    # The k+1 best of the fp64 logits, ties on the lowest index.
    order = np.argsort(-logits64, axis=1, kind="stable")[:, :k + 1]
    best = np.take_along_axis(logits64, order, 1)
    gaps = best[:, :-1] - best[:, 1:]                      # [M, k]
    clear = gaps > TOL
    clear[:, 1:] &= gaps[:, :-1] > TOL
    assert clear.mean() > 0.9                              # the check bites
    np.testing.assert_array_equal(idx.numpy()[clear], ridx[clear])
    np.testing.assert_array_equal(idx.numpy()[clear], order[:, :k][clear])


def _check(m, e, v, k, w_layout, dtype=jnp.float32, seed=0, bias=True):
    rng = np.random.RandomState(seed)
    h = jnp.asarray(rng.randn(m, e), dtype)
    wshape = (v, e) if w_layout == "ve" else (e, v)
    w = jnp.asarray(rng.randn(*wshape) * 0.05, dtype)
    b = jnp.asarray(rng.randn(v), jnp.float32) if bias else None

    kern = jtkp.project_topk(h, w, b, k, w_layout=w_layout, interpret=True)
    ref = jtkp.reference_topk(h, w, b, k, w_layout=w_layout)
    tw = _torch(w) if w_layout == "ve" else _torch(w).T.contiguous()
    got = tkp.project_topk(_torch(h), tw, None if b is None else _torch(b), k)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    h64 = np.asarray(h, np.float64)
    w64 = np.asarray(w, np.float64)
    logits64 = h64 @ (w64.T if w_layout == "ve" else w64)
    if b is not None:
        logits64 = logits64 + np.asarray(b, np.float64)
    _assert_triple(got, kern, logits64)
    _assert_triple(got, ref, logits64)


@pytest.mark.parametrize("w_layout", ["ve", "ev"])
def test_parity_flagship_shape(w_layout):
    _check(256, 128, 2560, 4, w_layout)


@pytest.mark.parametrize("m", [8, 100, 128])
def test_parity_row_padding(m):
    _check(m, 128, 1280, 4, "ev", seed=m)


@pytest.mark.parametrize("k", [1, 2, 5, 16])
def test_parity_k_values(k):
    _check(128, 128, 2560, k, "ve", seed=k)


def test_parity_bf16_inputs():
    _check(128, 256, 1280, 4, "ev", dtype=jnp.bfloat16)


def test_parity_no_bias():
    _check(128, 128, 1280, 4, "ve", bias=False)


def _tie_inputs(v, tied):
    m, e = 128, 128
    h = np.ones((m, e), np.float32)
    w = np.zeros((v, e), np.float32)                  # "ve" layout
    b = np.zeros((v,), np.float32)
    for cols, value in tied:
        b[list(cols)] = value
    return h, w, b


@pytest.mark.parametrize("v,k,tied,want", [
    # within and across the JAX kernel's 1280-wide tiles
    (2560, 4, [((5, 700, 1300, 2000), 3.0), ((9, 1290), 2.0)],
     [5, 700, 1300, 2000]),
    # more tied maxima than k: the k lowest indices survive
    (1280, 2, [((40, 41, 42, 43), 1.0)], [40, 41]),
    # across the CUDA kernel's 128-column chunks
    (2560, 5, [((2559, 256, 255, 128, 127), 1.0)], [127, 128, 255, 256,
                                                    2559]),
])
def test_tie_break_lowest_index(v, k, tied, want):
    h, w, b = _tie_inputs(v, tied)
    kern = jtkp.project_topk(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b),
                             k, w_layout="ve", interpret=True)
    ref = jtkp.reference_topk(jnp.asarray(h), jnp.asarray(w),
                              jnp.asarray(b), k, w_layout="ve")
    got = tkp.project_topk(torch.tensor(h), torch.tensor(w), torch.tensor(b),
                           k)
    _assert_triple(got, kern)
    _assert_triple(got, ref)
    assert got[1][7].tolist() == want


@pytest.mark.parametrize("seed", range(3))
def test_stable_topk_matches_lax_top_k_on_ties(seed):
    """Rows full of ties: values and the order of equal values (ascending
    index) must be lax.top_k's."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 3, (16, 50)).astype(np.float32)
    x[0] = 0.0                                          # one all-tied row
    for k in (1, 4, 16, 50):
        rv, ri = jax.lax.top_k(jnp.asarray(x), k)
        v, i = tkp.stable_topk(torch.tensor(x), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


def test_project_topk_refuses_other_devices():
    h = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tkp.project_topk(h, torch.zeros((16, 8), device="meta"), None, 2)


@pytest.mark.parametrize("dtype,k,want", [("bfloat16", 4, "kernel"),
                                          ("bfloat16", 16, "kernel"),
                                          ("float32", 4, "plain"),
                                          ("bfloat16", 17, "plain")],
                         ids=["bf16_k4", "bf16_k16", "fp32", "bf16_k17"])
def test_seq2seq_routes_project_topk_by_dtype_and_k(monkeypatch, dtype, k,
                                                    want):
    """Off the CPU (the ``meta`` device, routed as the card is) a bf16 head
    with k <= 16 reaches the kernel's wrapper; fp32 weights and beams wider
    than 16 take the plain version, as the JAX model takes XLA's top_k where
    the kernel's gate says no."""
    from imagetranslate_tpu_torch.models.config import tiny_config
    from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq

    calls = []

    def record(name):
        def fn(h, w, b, k_):
            calls.append((name, tuple(h.shape), w.dtype, k_))
            m = h.shape[0]
            return (torch.empty(m, k_, device=h.device),
                    torch.empty(m, k_, dtype=torch.int32, device=h.device),
                    torch.empty(m, device=h.device))
        return fn

    monkeypatch.setattr(tkp, "project_topk", record("kernel"))
    monkeypatch.setattr(tkp, "project_topk_reference", record("plain"))
    model = Seq2Seq(tiny_config(dtype=dtype), device="meta")
    hidden = torch.empty(6, 1, 32, dtype=model.cfg.compute_dtype,
                         device="meta")
    val, idx, lse = model.project_topk(hidden, k)
    assert val.shape == (6, k) and lse.shape == (6,)
    assert calls == [(want, (6, 32), model.cfg.compute_dtype, k)]


def test_kernel_wrapper_still_refuses_a_bf16_call_it_cannot_take():
    h = torch.zeros((4, 16), dtype=torch.bfloat16, device="meta")
    w = torch.zeros((64, 16), dtype=torch.bfloat16, device="meta")
    b = torch.zeros((64,), device="meta")
    with pytest.raises(ValueError, match="1 <= k <= 16"):
        tkp._check_cuda_args(h, w, b, 17)


@pytest.mark.parametrize("v", [84, 30522, 32000, 32003])
@pytest.mark.parametrize("m", [1, 32, 128, 256, 768, 1000])
def test_work_plan_covers_the_vocab_in_ascending_ranges(m, v):
    """The kernel's plan (the C source refuses any other): ranges of whole
    vocab tiles cover [0, V) in ascending order, each holds at least one
    column below V, row tiles x ranges fill the SMs about once, the merge
    can hold every range, and the scratch follows from the plan."""
    for k in (1, 4, 5, 8, 16):
        plan = tkp.work_plan(m, v, k)
        tiles, row_tiles = -(-v // plan.cols), -(-m // tkp.ROW_TILE)
        assert plan.cols == (256 if k <= 4 else 128)
        bounds = [(r * plan.per * plan.cols,
                   min((r + 1) * plan.per * plan.cols, v))
                  for r in range(plan.ranges)]
        assert bounds[0][0] == 0 and bounds[-1][1] == v
        assert all(hi == lo for (_, hi), (lo, _) in zip(bounds, bounds[1:]))
        assert all(lo < hi for lo, hi in bounds)
        assert (plan.ranges - 1) * plan.per < tiles <= plan.ranges * plan.per
        assert plan.ranges <= tkp.SMS
        assert row_tiles * plan.ranges <= max(tkp.SMS, row_tiles)
        val, idx, ms = tkp.scratch(m, k, plan, "cpu")
        assert val.shape == idx.shape == (m, plan.ranges, k)
        assert ms.shape == (m, plan.ranges, 2)
        assert (val.dtype, idx.dtype, ms.dtype) == (torch.float32,
                                                    torch.int32,
                                                    torch.float32)
    # The decode paths' shapes: one wave of blocks, a few tens of ranges.
    if v == 32000:
        want = {256: (256, 2, 63), 768: (256, 6, 21), 128: (256, 1, 125),
                32: (256, 1, 125)}.get(m)
        if want is not None:
            assert tuple(tkp.work_plan(m, v, 4)) == want


def test_library_path_follows_sources_and_headers(tmp_path, monkeypatch):
    """The build is keyed on every source and header under csrc/: an edited
    header must not load a library built before the edit."""
    import shutil

    from imagetranslate_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    first = _build.library_path()
    assert _build.library_path() == first
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    second = _build.library_path()
    assert second != first
    source = csrc / "topk_project.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    assert _build.library_path() not in (first, second)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernel vs its plain version on the card: at every decode
    path's M (256, 768, 128, 32) and ragged M, at each list length (k = 1,
    4, 16), over ragged V (a last tile and range with fewer columns than
    k); exact ties inside a thread's columns, across the quad that shares
    a row, across two vocab tiles of a block, across two ranges, one per
    range, and in a ragged last range; two launches bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    E, V = 768, 32000
    launches = tkp.LAUNCHES
    calls = 0
    cases = [(256, 4, V), (100, 16, V), (1, 1, V), (100, 16, 32003),
             (256, 4, 84), (768, 4, V), (128, 1, V), (32, 4, V),
             (1000, 16, V), (768, 16, 30522), (1, 4, 32003)]
    for m, k, v in cases:
        h = torch.randn(m, E, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(v, E, generator=gen, device="cuda") * 0.05).bfloat16()
        b = torch.randn(v, generator=gen, device="cuda") * 0.1
        val, idx, lse = tkp.project_topk(h, w, b, k)
        calls += 1
        rval, ridx, rlse = tkp.project_topk_reference(h, w, b, k)
        torch.cuda.synchronize()
        logits = h.float() @ w.float().T + b
        assert (val - rval).abs().max().item() <= 1e-4
        assert (lse - rlse).abs().max().item() <= 1e-4
        assert (logits.gather(1, idx.long()) - val).abs().max().item() <= 1e-4
        if m in (256, 768):
            again = tkp.project_topk(h, w, b, k)
            calls += 1
            assert all(torch.equal(x, y) for x, y in zip((val, idx, lse),
                                                         again))

    def tied(m, k, top, v=V, low=()):
        b = torch.zeros(v, device="cuda")
        b[list(top)] = 3.0
        if low:
            b[list(low)] = 2.0
        _, idx, _ = tkp.project_topk(
            torch.ones(m, E, device="cuda").bfloat16(),
            torch.zeros(v, E, device="cuda").bfloat16(), b, k)
        return idx.tolist()

    per_range = [r * 256 + (37 * r) % 256 for r in range(125)]
    ties = [
        ((3, 4, (127, 128, 255, 256, 31999)), [127, 128, 255, 256]),
        ((3, 6, (32002, 32000, 31999, 5), 32003),
         [5, 31999, 32000, 32002, 0, 1]),
        ((64, 3, (11, 10, 3, 2)), [2, 3, 10]),              # one thread
        ((130, 4, (6, 4, 2, 1, 0)), [0, 1, 2, 4]),          # the quad
        ((256, 3, (511, 257, 256, 255)), [255, 256, 257]),  # two tiles
        ((256, 4, (1024, 1023, 512, 511)), [511, 512, 1023, 1024]),
        ((768, 4, (3072, 3071, 1536, 1535)), [1535, 1536, 3071, 3072]),
        ((1, 16, per_range), per_range[:16]),               # one a range
        ((1, 16, (32002, 32000, 5), 32003),                 # ragged range
         [5, 32000, 32002] + [i for i in range(14) if i != 5]),
        ((768, 4, ()), [0, 1, 2, 3]),                       # all equal
    ]
    for args, want in ties:
        assert tied(*args) == [want] * args[0]
        calls += 1
    assert tkp.LAUNCHES == launches + calls
