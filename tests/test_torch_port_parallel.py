"""Data and tensor parallelism of the port (imagetranslate_tpu_torch/parallel,
``Seq2Seq.shard_``, the MT step, the beam decode) against the JAX package
under its meshes on the conftest's 8 virtual CPU devices. The port's ranks
are spawned processes joined over gloo on the CPU through a ``file://``
store (``parallel.spawn.run_ranks``; the rank functions are in
tests/_torch_port_ranks.py), rank r at the JAX device r's grid position.

- (a) the rule table: each rank's shard of a tiny Seq2Seq (plain, tied,
  lang_dec, MoE: the experts split) equals, through the weight bridge, the addressable shard that
  JAX ``shard_params`` puts on device r, on meshes 2x2 and 1x4; a model axis
  the heads do not divide replicates them with the same warning.
- (c) ``Seq2Seq.project_topk`` under a 1x2 mesh (K2b: per-shard top-k
  merged over the ranks) against the JAX model's under a TP mesh with its
  kernel forced (interpret mode): indices exact, values and lse 1e-5.
- (d) one MT step at dropout 0 under 2x2 (and 1x4, 4x1, and 2x2 and 4x1
  under ZeRO-1) against the JAX step
  under ``make_mesh(2, 2)``: the data halves hold different token counts
  (the loss is the global sum over the global count) and the clip binds
  (replicated parameters counted once in the global norm). Loss 1e-5;
  the gathered Adam first moments (0.1 x the clipped gradients) and
  parameters rtol 1e-4, with an atol of 1e-9 for the key biases, whose
  gradients are zero but for rounding (~1e-15 in both packages).
- (e) the tensor-parallel beam decode (fp32, 1x2, and 2x1 with the rows
  split and the early exit joined) against the one-process port and the
  JAX decode: tokens and lengths equal, ``ref_ties=True``.
- the CLI chain, ``slow``: ``cli.train_mt --mesh 1x2`` under torchrun for
  two steps, ``cli.translate --dp 2`` against ``--dp 0`` byte for byte, the
  checkpoint loaded by the one-process port and by the JAX package.
"""

import dataclasses
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.models.seq2seq import Seq2Seq as JaxSeq2Seq
from imagetranslate_tpu.parallel import mesh as jmesh
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
from imagetranslate_tpu_torch.parallel.mesh import ProcessMesh, param_spec
from imagetranslate_tpu_torch.parallel.spawn import run_ranks
from imagetranslate_tpu_torch.train.weights import (
    random_params,
    state_dict_from_flax,
    state_dict_shard_from_flax,
)

import _torch_port_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------- (a) the rule table ----------------

VARIANTS = {"plain": {}, "tied": {"tie_embed": True},
            "lang_dec": {"lang_dec": True}, "moe": {"moe_experts": 4}}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("n_data, n_model", [(2, 2), (1, 4)])
def test_rank_shards_equal_jax_addressable_shards(variant, n_data, n_model):
    kw = VARIANTS[variant]
    cfg = tiny_config(vocab_size=64, **kw)
    params = random_params(cfg, 0)
    jparams = jmesh.shard_params(params, jmesh.make_mesh(n_data, n_model))
    devices = jax.devices()
    n_split = 0
    for r in range(n_data * n_model):
        local = jax.tree.map(
            lambda a: next(np.asarray(s.data) for s in a.addressable_shards
                           if s.device == devices[r]), jparams)
        want = state_dict_from_flax(local, cfg)
        d, m = divmod(r, n_model)
        got = state_dict_shard_from_flax(params, cfg,
                                         ProcessMesh(n_data, n_model, d, m))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                          err_msg=k)
            n_split += got[k].shape != state_dict_from_flax(
                params, cfg)[k].shape
    assert n_split > 0


def test_indivisible_heads_replicate_loudly():
    """Eight model shards of four heads: the attention falls back to
    replication in both packages, with a warning; the FFN and the vocab
    still split."""
    cfg = tiny_config(vocab_size=64)
    params = random_params(cfg, 0)
    with pytest.warns(UserWarning, match="fell back to replication"):
        jparams = jmesh.shard_params(params, jmesh.make_mesh(1, 8))
    with pytest.warns(UserWarning, match="fell back to replication"):
        got = state_dict_shard_from_flax(params, cfg, ProcessMesh(1, 8, 0, 3))
    local = jax.tree.map(
        lambda a: next(np.asarray(s.data) for s in a.addressable_shards
                       if s.device == jax.devices()[3]), jparams)
    want = state_dict_from_flax(local, cfg)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    q = "encoder.encoder.layer.0.attention.self.query.weight"
    ffn = "encoder.encoder.layer.0.intermediate.dense.weight"
    assert got[q].shape == (32, 32) and got[ffn].shape == (8, 32)
    assert param_spec(q) == (0, True) and param_spec(
        "output_layer.layer.bias", tie_embed=True) is None


def test_parse_mesh_batch_rows_and_single_process():
    """The JAX grammar of --mesh (an error on "4x2x1"), a single process
    without torchrun's environment, and this rank's batch rows: the data
    index's slice, or the whole array with a warning where the data axis
    does not divide the rows (as JAX ``shard_batch_safe``)."""
    from imagetranslate_tpu_torch.parallel import comm
    from imagetranslate_tpu_torch.parallel.mesh import (
        init_distributed,
        model_axis_size,
        parse_mesh,
        shard_batch_safe,
    )

    assert parse_mesh("") is None and parse_mesh(None) is None
    assert model_axis_size(None) == 1
    assert model_axis_size(ProcessMesh(4, 2)) == 2
    assert ProcessMesh(2, 2, d=1, m=0).rank == 2
    for bad in ("4x2x1", "x2", "2x"):
        with pytest.raises(ValueError, match="bad --mesh spec"):
            parse_mesh(bad)
    with pytest.MonkeyPatch.context() as mp:
        for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
            mp.delenv(var, raising=False)
        assert init_distributed(device="cpu") is False
    x = torch.arange(8)
    assert comm.all_reduce_sum(x, None) is x
    assert comm.all_gather_stack(x, None).shape == (1, 8)
    assert comm.tp_copy(x, None) is x and comm.tp_reduce(x, None) is x
    batch = {"src": torch.arange(16).reshape(8, 2), "n": 3,
             "neg": torch.arange(6).reshape(3, 2)}
    with pytest.warns(UserWarning, match="not divisible by the data axis"):
        got = shard_batch_safe(batch, ProcessMesh(2, 2, d=1, m=1))
    assert got["src"].tolist() == batch["src"][4:].tolist()
    assert got["neg"] is batch["neg"] and got["n"] == 3
    want = jmesh.shard_batch_safe({"src": np.asarray(batch["src"])},
                                  jmesh.make_mesh(2, 2))["src"]
    jax_rows = next(np.asarray(s.data) for s in want.addressable_shards
                    if s.device == jax.devices()[3])      # rank 3: d=1, m=1
    np.testing.assert_array_equal(got["src"].numpy(), jax_rows)


# ---------------- (c) Seq2Seq.project_topk under a mesh ----------------

def _topk_cfg(tie):
    return dict(vocab_size=1024, num_languages=2, hidden_size=128,
                num_heads=4, intermediate_size=256,
                max_position_embeddings=32, enc_layers=1, dec_layers=1,
                dropout=0.0, attention_dropout=0.0, dtype="float32",
                use_pallas_attention=False, tie_embed=tie)


def _jax_project_topk_tp(cfg_kw, params, h, k):
    from imagetranslate_tpu.models.config import Seq2SeqConfig
    from imagetranslate_tpu.ops import runtime
    from imagetranslate_tpu.ops import topk_project as jtkp

    model = JaxSeq2Seq(Seq2SeqConfig(**cfg_kw))
    orig = jtkp.project_topk

    def forced(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    jtkp.project_topk = forced
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                             ("data", "model"))
    try:
        prev = runtime.set_spmd_lowering(True, mesh)
        with runtime.force_tpu_lowering():
            out = model.apply(params, jnp.asarray(h), k,
                              method=JaxSeq2Seq.project_topk)
    finally:
        runtime.set_spmd_lowering(prev)
        jtkp.project_topk = orig
    return [np.asarray(a) for a in out]


@pytest.fixture(scope="module")
def topk_cases(tmp_path_factory):
    """(tie, params, h) per case and the port's triples per rank, from one
    spawn of two ranks."""
    from imagetranslate_tpu_torch.models.config import Seq2SeqConfig

    cases = []
    for tie in (True, False):
        cfg = Seq2SeqConfig(**_topk_cfg(tie))
        params = random_params(cfg, 1)
        p = params["params"]
        bias = np.random.RandomState(2).randn(1024).astype(np.float32)
        if tie:
            p["out_bias_0"] = bias
        else:
            p["output_layers_0"]["proj"]["bias"] = bias
        h = np.random.RandomState(3).randn(16, 128).astype(np.float32)
        cases.append((cfg, params, h))
    got = run_ranks(ranks.project_topk, 2,
                    str(tmp_path_factory.mktemp("topk") / "store"),
                    (cases, 4))
    return [(tie, params, h, [per_rank[i] for per_rank in got])
            for i, (tie, (_, params, h)) in enumerate(zip((True, False),
                                                          cases))]


@pytest.mark.parametrize("case", [0, 1])
def test_seq2seq_project_topk_under_tp_matches_jax(topk_cases, case):
    tie, params, h, got = topk_cases[case]
    want = _jax_project_topk_tp(_topk_cfg(tie), params, h, 4)
    for val, idx, lse in got:      # every rank: the same merged triple
        np.testing.assert_array_equal(idx, want[1])
        np.testing.assert_allclose(val, want[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lse, want[2], rtol=1e-5, atol=1e-5)


# ---------------- (d) one MT step under a mesh ----------------

STEP = dict(lr=1e-3, warmup=1, clip=0.05)


def _step_batch():
    """8 rows; the first data half's targets are 2 tokens long, so the two
    halves hold different token counts."""
    rng = np.random.RandomState(3)
    B, S, T = 8, 7, 6
    src = rng.randint(5, 64, (B, S)).astype(np.int32)
    dst = rng.randint(5, 64, (B, T)).astype(np.int32)
    smask = np.ones((B, S), bool)
    dmask = np.ones((B, T), bool)
    for r in range(B):
        smask[r, rng.randint(2, S):] = False
        if r < B // 2:
            dmask[r, 2:] = False
    src[~smask] = 0
    dst[~dmask] = 0
    return {"src": src, "src_mask": smask, "dst": dst, "dst_mask": dmask,
            "src_langs": np.zeros(B, np.int32),
            "dst_langs": np.ones(B, np.int32), "row_mask": np.ones(B, bool)}


@pytest.fixture(scope="module")
def jax_step():
    """The JAX MT step under make_mesh(2, 2): (loss, params, Adam mu) as
    port state dicts."""
    from imagetranslate_tpu.train.optimizer import build_optimizer
    from imagetranslate_tpu.train.step import (
        create_train_state,
        make_mt_train_step,
    )
    from imagetranslate_tpu.ops import runtime

    cfg = tiny_config(vocab_size=64)
    params = random_params(cfg, 0)
    mesh = jmesh.make_mesh(2, 2)
    try:
        opt = build_optimizer(lr=STEP["lr"], warmup_updates=STEP["warmup"],
                              clip_norm=STEP["clip"])
        state = create_train_state(jmesh.shard_params(params, mesh), opt)
        step = make_mt_train_step(JaxSeq2Seq(jax_tiny_config(vocab_size=64)),
                                  opt, donate=False)
        batch = jmesh.shard_batch_safe(
            {k: jnp.asarray(v) for k, v in _step_batch().items()}, mesh)
        state, m = step(state, batch, jax.random.PRNGKey(0))
        loss = float(m["sum_loss"]) / float(m["ntokens"])
        new = state_dict_from_flax(_np_tree(state.params), cfg)
        mu = state_dict_from_flax(_np_tree(state.opt_state[1].mu), cfg)
    finally:
        runtime.set_spmd_lowering(False)
    return cfg, params, loss, new, mu


# The last two under ZeRO-1, its layout's min_size lowered to 512 so that
# the tiny model's tensors split (tests/test_torch_port_zero.py holds the
# placement and the trainer at JAX's 4096).
MESHES = [(2, 2), (1, 4), (4, 1), (2, 2, 512), (4, 1, 512)]


@pytest.fixture(scope="module")
def port_steps(jax_step, tmp_path_factory):
    """Per mesh, each rank's result, from one spawn of four ranks."""
    cfg, params = jax_step[:2]
    got = run_ranks(ranks.train_step, 4,
                    str(tmp_path_factory.mktemp("step") / "store"),
                    (cfg, params, _step_batch(), MESHES, STEP["lr"],
                     STEP["warmup"], STEP["clip"]))
    return [[per_rank[i] for per_rank in got] for i in range(len(MESHES))]


@pytest.mark.parametrize("mesh", range(len(MESHES)))
def test_mt_step_under_a_mesh_matches_jax(jax_step, port_steps, mesh):
    cfg, params, loss, new, mu = jax_step
    tokens = _step_batch()["dst_mask"][:, 1:].sum()
    for sum_l, n, got, got_mu, n_split in port_steps[mesh]:
        assert n == tokens                      # the global count
        assert (n_split > 0) == (len(MESHES[mesh]) == 3)
        np.testing.assert_allclose(sum_l / n, loss, rtol=1e-5)
        for k in new:
            np.testing.assert_allclose(got[k], new[k].numpy(), rtol=1e-4,
                                       atol=1e-9, err_msg=k)
            np.testing.assert_allclose(got_mu[k], mu[k].numpy(), rtol=1e-4,
                                       atol=1e-9, err_msg=k)
    # The clip bound: the moments are 0.1 x the clipped gradient, whose
    # norm is the clip (a norm that counted replicated parameters n_model
    # times would clip harder).
    norm = np.sqrt(sum(np.sum(np.square(v / 0.1))
                       for v in port_steps[mesh][0][3].values()))
    np.testing.assert_allclose(norm, STEP["clip"], rtol=1e-4)


# ---------------- (e) the tensor-parallel beam decode ----------------

@pytest.fixture(scope="module")
def decode_setup():
    V, B, S = 32, 4, 6
    kw = {"initializer_range": 0.15}
    cfg = tiny_config(vocab_size=V, **kw)
    jcfg = jax_tiny_config(vocab_size=V, **kw)
    rng = np.random.RandomState(0)
    src = rng.randint(5, V, (B, S)).astype(np.int32)
    for row, n in enumerate((S, 4, 2, 5)):
        src[row, n:] = 0
    mask = src != 0
    sizes = mask.sum(axis=1).astype(np.int32)
    langs = np.zeros(B, np.int32)
    tgt = np.ones(B, np.int32)
    first = np.full(B, 6, np.int32)
    params = random_params(cfg, 0)
    return cfg, jcfg, params, (src, mask, langs, first, tgt, sizes)


BEAM = dict(beam_width=4, max_len=14, pad_id=0, eos_id=4, ref_ties=True)


def test_tp_beam_decode_matches_one_process_and_jax(decode_setup, tmp_path):
    from imagetranslate_tpu.decoding.beam import beam_search as jax_beam
    from imagetranslate_tpu_torch.decoding.beam import beam_search

    cfg, jcfg, params, (src, mask, langs, first, tgt, sizes) = decode_setup
    jm = JaxSeq2Seq(jcfg)
    enc = jm.apply(params, src, mask, langs, method=JaxSeq2Seq.encode)
    want = [np.asarray(a) for a in jax_beam(
        jm, params, enc, mask, first, tgt, sizes, None, None, **BEAM)]
    model = Seq2Seq(cfg)
    model.load_state_dict(state_dict_from_flax(params, cfg))
    with torch.no_grad():
        one = beam_search(model.eval(), model.encode(
            torch.tensor(src), torch.tensor(mask), torch.tensor(langs)),
            torch.tensor(mask), torch.tensor(first), torch.tensor(tgt),
            torch.tensor(sizes), **BEAM)
    for a, b in zip(one, want):
        np.testing.assert_array_equal(a.numpy(), b)
    # 1x2 (tensor parallel) and 2x1 (rows split) in one spawn of two ranks
    # each would need two worlds; the 1x2 world runs both meshes' decodes.
    got = run_ranks(ranks.beam_decode, 2, str(tmp_path / "store"),
                    (cfg, params, src, mask, langs, first, tgt, sizes,
                     BEAM))
    for per_rank in got:
        for best, lengths in per_rank:
            np.testing.assert_array_equal(best, want[0])
            np.testing.assert_array_equal(lengths, want[1])


# ---------------- the CLI chain under torchrun ----------------

WORDS = ["alpha", "beta", "gamma", "delta", "epsi", "zeta", "eta", "theta"]


def _torchrun(n, module, *args):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "-m", module, *args],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.slow
def test_cli_mesh_train_then_translate_dp(tmp_path):
    """``cli.train_mt --mesh 1x2`` for two steps and a dev decode (through
    K2b) under torchrun, then ``cli.translate --dp 2`` against ``--dp 0``
    byte for byte, and the checkpoint read by the one-process port and by
    the JAX package.
    Slow: three torchrun launches of two ranks, each rank a new Python
    process that imports torch (~12 s in all on 8 CPU cores)."""
    from imagetranslate_tpu.train import checkpoint as jckpt
    from imagetranslate_tpu_torch.cli.translate import main as translate
    from imagetranslate_tpu_torch.data import binarize
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train import checkpoint as ckpt

    rng = np.random.RandomState(0)
    lines = [" ".join(WORDS[j] for j in rng.randint(0, 8, rng.randint(2, 7)))
             for _ in range(60)]
    for name in ("train.src", "train.dst"):
        (tmp_path / name).write_text("\n".join(lines) + "\n")
    TextProcessor().train_tokenizer([str(tmp_path / "train.src")], 120,
                                    str(tmp_path / "tok"),
                                    {"<aa>": 0, "<bb>": 1})
    tp = TextProcessor(str(tmp_path / "tok"))
    binarize.write_mt(tp, str(tmp_path / "train.mt"),
                      str(tmp_path / "train.src"), tp.token_id("<aa>"),
                      str(tmp_path / "train.dst"), tp.token_id("<bb>"))
    model = tmp_path / "model"
    out = _torchrun(
        2, "imagetranslate_tpu_torch.cli.train_mt", "--mesh", "1x2",
        "--tok", str(tmp_path / "tok"), "--model", str(model), "--train_mt",
        str(tmp_path / "train.mt"), "--embed", "48", "--intermediate", "64",
        "--enc", "2", "--dec", "2", "--batch", "1200", "--lr", "0.005",
        "--warmup", "20", "--dtype", "float32", "--step", "2", "--device",
        "cpu", "--dev_mt", str(tmp_path / "train.mt"), "--beam", "2")
    assert "Finished Training!" in out and "BLEU:" in out
    assert (model / "bleu.output").exists()      # rank 0 wrote the dev decode
    latest = str(model) + ".latest"
    params, opt_tree, meta = ckpt.load_checkpoint(latest, with_opt_state=True)
    assert meta["step"] == 2 and opt_tree is not None
    cfg = ckpt.load_config(latest)
    one = Seq2Seq(cfg)
    one.load_state_dict(state_dict_from_flax(params, cfg))   # full shapes
    from imagetranslate_tpu.train.optimizer import build_optimizer

    template = jax.tree.map(lambda t: np.zeros(t.shape, np.float32), params)
    jparams, jopt, jmeta = jckpt.load_checkpoint(
        latest, template, build_optimizer(warmup_updates=20).init(template))
    assert jmeta["step"] == 2 and int(jopt[1].count) == 2
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), b.numpy()), jparams, params)

    args = ["--tok", str(tmp_path / "tok"), "--model", latest, "--input",
            str(tmp_path / "train.src"), "--src", "aa", "--target", "bb",
            "--batch", "100", "--device", "cpu"]
    translate(args + ["--output", str(tmp_path / "dp0.out")])
    _torchrun(2, "imagetranslate_tpu_torch.cli.translate", *args, "--dp",
              "2", "--output", str(tmp_path / "dp2.out"))
    want = (tmp_path / "dp0.out").read_bytes()
    assert len(want.splitlines()) == 60
    assert (tmp_path / "dp2.out").read_bytes() == want
