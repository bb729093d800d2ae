"""ZeRO-1 of the port (imagetranslate_tpu_torch/parallel/zero.py,
``MTTrainer(zero=True)``) against the JAX package's
(``parallel/mesh.py::zero_opt_shardings``, tests/test_zero.py), fp32
``tiny_config`` widened so that tensors reach JAX's 4096-element floor
(V = 256, F = 128).

- the placement: for meshes 2x1, 4x1 and 2x2 each moment tensor's split
  dim (in the flax layout) is the one JAX ``zero_opt_shardings`` gives the
  data axis on ShapeDtypeStructs with the tensor-parallel shardings (no
  compile), and a rank's slice holds the elements of JAX's shard on its
  device;
- three steps under 4x1 with ``--acc`` 2 and under 2x2 with ``--acc`` 1,
  with and without ZeRO (one spawn of four ranks): the losses and the checkpoints (weights
  and the gathered optimizer state) equal to rtol 1e-5; each rank's
  optimizer state falls by (1 - 1/D) of the split tensors' bytes; a trainer
  that loads the checkpoint's optimizer state (``--cont``) holds the same
  slices. The step against the JAX step is in tests/test_torch_port_parallel.py
  (its ``jax_step``).
"""

import jax
import numpy as np
import pytest
import torch

from imagetranslate_tpu.parallel import mesh as jmesh
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.parallel.mesh import (
    ProcessMesh,
    shard_params,
    shard_plan,
)
from imagetranslate_tpu_torch.parallel.spawn import run_ranks
from imagetranslate_tpu_torch.parallel.zero import ZeroLayout
from imagetranslate_tpu_torch.train import checkpoint as ckpt
from imagetranslate_tpu_torch.train.weights import (
    random_params,
    state_dict_from_flax,
)

import _torch_port_ranks as ranks

CFG = tiny_config(vocab_size=256, intermediate_size=128)
OPT = dict(lr=1e-3, warmup=1, clip=0.05)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout(n_data, n_model, d=0, m=0):
    """The full state_dict, this rank's TP shard of it, the plan and the
    ZeRO layout at grid position (d, m)."""
    mesh = ProcessMesh(n_data, n_model, d, m)
    full = state_dict_from_flax(random_params(CFG, 0), CFG)
    plan = shard_plan({k: tuple(v.shape) for k, v in full.items()}, mesh, CFG)
    local = shard_params(full, mesh, plan)
    layout = ZeroLayout({k: v.shape for k, v in local.items()}, mesh,
                        CFG, plan)
    return full, local, plan, layout


def _port_keys(tree):
    """A flax-layout tree of per-leaf constants -> {port key: constant}."""
    sd = state_dict_from_flax(jax.tree.map(np.asarray, tree), CFG)
    return {k: int(v.reshape(-1)[0]) for k, v in sd.items()}


@pytest.mark.parametrize("n_data, n_model", [(2, 1), (4, 1), (2, 2)])
def test_placement_matches_jax(n_data, n_model):
    params = random_params(CFG, 0)
    mesh = jmesh.make_mesh(n_data, n_model)
    shardings = jmesh.param_shardings(params, mesh)
    structs = jax.tree.map(
        lambda a, sh: jax.ShapeDtypeStruct(a.shape, np.float32, sharding=sh),
        params, shardings)
    specs = jmesh.zero_opt_shardings(structs, mesh)

    def data_dim(a, spec):
        if isinstance(spec, str):              # "keep"
            return np.full(a.shape, -1)
        return np.full(a.shape, list(spec.spec).index("data"))

    want = _port_keys(jax.tree.map(data_dim, params, specs))
    _, _, _, layout = _layout(n_data, n_model)
    got = {k: -1 if d is None else d for k, d in layout.flax_dims.items()}
    assert got == want
    assert sum(d >= 0 for d in got.values()) >= 4


def test_slices_hold_jax_shards():
    """2x2: each rank's slice of each split tensor holds the elements JAX's
    ``zero_shard_opt_state`` puts on that rank's device."""
    params = random_params(CFG, 0)
    rng = np.random.RandomState(1)
    values = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), params)
    mesh = jmesh.make_mesh(2, 2)
    placed = jmesh.zero_shard_opt_state(jmesh.shard_params(values, mesh),
                                        mesh)
    devices = jax.devices()
    n_split = 0
    for r in range(4):
        d, m = divmod(r, 2)
        shard = jax.tree.map(
            lambda a: next(np.asarray(s.data) for s in a.addressable_shards
                           if s.device == devices[r]), placed)
        # The flax block on device r, keyed by port key (values flattened).
        blocks = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(shard)[0]:
            blocks[jax.tree_util.keystr(path)] = np.sort(leaf.reshape(-1))
        mesh_r = ProcessMesh(2, 2, d, m)
        full = state_dict_from_flax(values, CFG)
        plan = shard_plan({k: tuple(v.shape) for k, v in full.items()},
                          mesh_r, CFG)
        local = shard_params(full, mesh_r, plan)
        layout = ZeroLayout({k: v.shape for k, v in local.items()}, mesh_r,
                            CFG, plan)
        sorted_blocks = set(tuple(b) for b in blocks.values())
        for k, t in local.items():
            if layout.split(k):
                mine = np.sort(layout.local(t, k).numpy())
                assert mine.size == t.numel() // 2
                assert tuple(mine) in sorted_blocks, k
                n_split += 1
    assert n_split > 0


# (n_data, n_model, zero, accum): each case with ZeRO after its twin
# without; --acc 2 at 4x1, --acc 1 at 2x2.
STEP_CASES = [(4, 1, False, 2), (4, 1, True, 2), (2, 2, False, 1),
              (2, 2, True, 1)]


def _mt_batch(seed, B=8, S=7, T=6):
    rng = np.random.RandomState(seed)
    src = rng.randint(5, 256, (B, S)).astype(np.int32)
    dst = rng.randint(5, 256, (B, T)).astype(np.int32)
    smask = np.ones((B, S), bool)
    dmask = np.ones((B, T), bool)
    for r in range(B):
        smask[r, rng.randint(2, S):] = False
        dmask[r, rng.randint(2, T):] = False
    src[~smask] = 0
    dst[~dmask] = 0
    return {"src": src, "src_mask": smask, "dst": dst, "dst_mask": dmask,
            "src_langs": np.zeros(B, np.int32),
            "dst_langs": np.ones(B, np.int32), "row_mask": np.ones(B, bool)}


@pytest.fixture(scope="module")
def zero_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero")
    batches = [("mt", _mt_batch(s)) for s in (3, 4, 5)]
    got = run_ranks(ranks.zero_steps, 4, str(out / "store"),
                    (CFG, random_params(CFG, 0), batches, STEP_CASES, OPT,
                     str(out)))
    return out, got


def _tree_close(a, b):
    jax.tree.map(lambda x, y: np.testing.assert_allclose(
        np.asarray(x), np.asarray(y), rtol=1e-5, atol=1e-9), a, b)


@pytest.mark.parametrize("case", [1, 3], ids=["4x1-acc2", "2x2"])
def test_zero_steps_and_checkpoint_equal_unsharded(zero_runs, case):
    out, got = zero_runs
    n_data, n_model, _, accum = STEP_CASES[case]
    for per_rank in got:
        np.testing.assert_allclose(per_rank[case][0], per_rank[case - 1][0],
                                   rtol=1e-5)
        assert per_rank[case][3] and per_rank[case - 1][3]   # resumed alike
    zp, zo, zm = ckpt.load_checkpoint(str(out / f"case{case}"),
                                      with_opt_state=True)
    p, o, m = ckpt.load_checkpoint(str(out / f"case{case - 1}"),
                                   with_opt_state=True)
    assert zm["step"] == m["step"] == 3
    _tree_close(zp, p)
    _tree_close(zo, o)
    # The optimizer state on each rank falls by the split tensors' bytes
    # times (1 - 1/D): mu and nu, and the running mean under --acc 2.
    for r, per_rank in enumerate(got):
        _, local, _, layout = _layout(n_data, n_model, *divmod(r, n_model))
        dims = per_rank[case][2]
        assert dims == layout.flax_dims
        split = sum(t.numel() * 4 for k, t in local.items()
                    if dims[k] is not None)
        copies = 3 if accum > 1 else 2
        assert per_rank[case - 1][1] - per_rank[case][1] == \
            copies * split * (n_data - 1) // n_data
        assert split > 0
