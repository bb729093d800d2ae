"""GPipe pipeline parallelism of the port (imagetranslate_tpu_torch/parallel/
pipeline.py, ``MTTrainer(pp_microbatches=M)``) against the JAX package's
(imagetranslate_tpu/parallel/pipeline.py), fp32 ``tiny_config`` at dropout
0. The ranks are spawned processes over gloo on the CPU
(``parallel.spawn.run_ranks``; the rank functions are in
tests/_torch_port_ranks.py), one spawn a module fixture.

- ``stage_counts`` and the stages' layers against JAX ``_stage_counts``,
  ``_active_mask`` and ``split_pipeline_params`` / ``merge_pipeline_params``
  for 6 and 3 layers over 2 and 4 stages: each stage holds JAX's active
  slots and nothing of the dummy ones, and the merge gives the one-device
  state back;
- one pipelined MT step at mesh 1x2 (M = 2) against one JAX
  ``make_mt_train_step_pp`` step under ``make_mesh(1, 2)``: the loss and
  the merged parameters to rtol 1e-4;
- the MASS step and the packed step at 1x2, and two steps of 6 + 3 layers at
  1x4 (M = 4; the last stage holds no decoder layer) against the port's
  one-process step; each rank holds its stage's layers only; one spawn of
  four ranks (the 1x2 cases on ranks 0 and 1). ``slow``: the pipeline at
  2x2 under ZeRO-1, and the CLI under torchrun.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagetranslate_tpu.models.config import tiny_config as jax_tiny_config
from imagetranslate_tpu.parallel import mesh as jmesh
from imagetranslate_tpu.parallel import pipeline as jpl
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.parallel import pipeline as pl
from imagetranslate_tpu_torch.parallel.spawn import run_ranks
from imagetranslate_tpu_torch.train.trainer_mt import MTTrainer
from imagetranslate_tpu_torch.train.weights import (
    random_params,
    state_dict_from_flax,
)

import _torch_port_ranks as ranks

OPT = dict(lr=1e-3, warmup=1, clip=0.05)
V = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mt_batch(seed, B=8, S=7, T=6):
    rng = np.random.RandomState(seed)
    src = rng.randint(5, V, (B, S)).astype(np.int32)
    dst = rng.randint(5, V, (B, T)).astype(np.int32)
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


def _mass_batch(seed, B=8, S=9):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(4, S + 1, B).astype(np.int32)
    src = rng.randint(5, V, (B, S)).astype(np.int32)
    mask = np.arange(S)[None, :] < lengths[:, None]
    src[~mask] = 0
    return {"src": src, "src_mask": mask, "langs": np.zeros(B, np.int32),
            "lang_tokens": src[:, 0].copy(), "lengths": lengths,
            "row_mask": np.ones(B, bool)}


def _packed_batch():
    from imagetranslate_tpu_torch.data.packing import pack_mt_examples

    r = np.random.RandomState(11)
    examples = []
    for _ in range(24):
        ls, ld = r.randint(3, 9), r.randint(3, 9)
        examples.append((r.randint(5, V, ls).tolist(),
                         r.randint(5, V, ld).tolist(), 0, 1))
    examples.sort(key=lambda e: len(e[1]))
    b = pack_mt_examples(examples, src_budget=24, dst_budget=24,
                         rows_per_batch=8, max_seq_len=20)[0]
    return {k: np.asarray(getattr(b, k)) for k in (
        "src", "src_seg", "src_pos", "dst", "dst_seg", "dst_pos",
        "src_langs", "dst_langs")}


CFG = tiny_config(vocab_size=V)                             # 2 + 2 layers
DEEP = tiny_config(vocab_size=V, enc_layers=6, dec_layers=3)
MT = [("mt", _mt_batch(s)) for s in (3, 4)]


def _one_process(cfg, params, batches):
    """The port's one-process trainer on the same batches: losses and the
    updated state_dict."""
    trainer = MTTrainer(cfg, ranks.Tok(), params=params, device="cpu", **OPT)
    losses = []
    for i, (kind, b) in enumerate(batches):
        fn = trainer.mass_step if kind == "mass" else trainer.mt_step
        trainer.state, m = fn(trainer.state, {k: torch.tensor(v)
                                              for k, v in b.items()},
                              torch.Generator().manual_seed(i))
        losses.append(float(m["sum_loss"]) / float(m["ntokens"]))
    return losses, {k: v.numpy() for k, v in
                    trainer.model.state_dict().items()}


# ---------------- the layout ----------------

@pytest.mark.parametrize("n_layers, stages", [(6, 2), (3, 2), (6, 4), (3, 4)])
def test_stage_counts_match_jax(n_layers, stages):
    counts, slots = pl.stage_counts(n_layers, stages)
    assert (counts, slots) == tuple(jpl._stage_counts(n_layers, stages))
    active = np.asarray(jpl._active_mask(n_layers, stages))
    for s in range(stages):
        layers = pl.stage_layers(n_layers, stages, s)
        assert len(layers) == active[s].sum() == counts[s]
    got = [i for s in range(stages)
           for i in pl.stage_layers(n_layers, stages, s)]
    assert got == list(range(n_layers))             # contiguous, in order


@pytest.mark.parametrize("stages", [2, 4])
def test_split_and_merge_match_jax(stages):
    """Each stage holds JAX's active slots (6 encoder and 3 decoder layers:
    at 4 stages the last holds no decoder layer) and the rest; merging the
    stages gives the one-device state_dict."""
    params = random_params(DEEP, 0)
    full = state_dict_from_flax(params, DEEP)
    jsplit = jpl.split_pipeline_params(params, DEEP, stages)
    stage_sds = [pl.split_pipeline_params(full, DEEP, stages, s)
                 for s in range(stages)]
    for stack, kind, n in (("enc", "encoder.encoder", 6),
                           ("dec", "decoder.decoder", 3)):
        tree = "encoder" if stack == "enc" else "decoders_0"
        for s, sd in enumerate(stage_sds):
            mine = sorted({int(k.split(".")[3]) for k in sd
                           if k.startswith(kind)})
            assert mine == list(pl.stage_layers(n, stages, s))
            for j, i in enumerate(mine):
                want = jax.tree.map(lambda a: np.asarray(a)[s, j],
                                    jsplit[stack])
                ref = params["params"][tree][f"layers_{i}"]
                jax.tree.map(np.testing.assert_array_equal, want, ref)
            for j in range(len(mine), pl.stage_counts(n, stages)[1]):
                # JAX's dummy slots are zeros; the port holds nothing.
                assert all(not np.any(np.asarray(a)[s, j])
                           for a in jax.tree.leaves(jsplit[stack]))
    for sd in stage_sds:
        assert "encoder.embeddings.word_embeddings.weight" in sd
        assert "output_layer.layer.weight" in sd
    merged = pl.merge_pipeline_params(stage_sds, DEEP, stages)
    assert merged.keys() == full.keys()
    for k in full:
        assert merged[k] is full[k]
    jmerged = jpl.merge_pipeline_params(jsplit, DEEP, stages)
    jax.tree.map(np.testing.assert_array_equal, jmerged, params)


# ---------------- the pipelined steps ----------------

@pytest.fixture(scope="module")
def pipelined(tmp_path_factory):
    """One spawn of four ranks: at 1x2 (M = 2, ranks 0 and 1) an MT step,
    a MASS step and a packed step of the 2 + 2 model; then at 1x4 (M = 4)
    two MT steps of the 6 + 3 model."""
    params, deep = random_params(CFG, 0), random_params(DEEP, 0)
    cases = [(CFG, params, 1, 2, 2, False, MT[:1]),
             (CFG, params, 1, 2, 2, False, [("mass", _mass_batch(5))]),
             (CFG, params, 1, 2, 2, False, [("mt", _packed_batch())]),
             (DEEP, deep, 1, 4, 4, False, MT)]
    got = run_ranks(ranks.pipeline_steps, 4,
                    str(tmp_path_factory.mktemp("pp") / "store"),
                    (cases, OPT))
    return cases, got


def _jax_pp_step(params, batch):
    """One JAX make_mt_train_step_pp step under make_mesh(1, 2), M = 2:
    the loss and the merged parameters as a port state_dict."""
    from imagetranslate_tpu.ops import runtime
    from imagetranslate_tpu.train.optimizer import build_optimizer
    from imagetranslate_tpu.train.step import create_train_state

    jcfg = jax_tiny_config(vocab_size=V)
    mesh = jmesh.make_mesh(1, 2)
    try:
        opt = build_optimizer(lr=OPT["lr"], warmup_updates=OPT["warmup"],
                              clip_norm=OPT["clip"])
        pp = jpl.shard_pipeline_params(
            jpl.split_pipeline_params(params, jcfg, 2), mesh)
        state = create_train_state(pp, opt)
        step = jpl.make_mt_train_step_pp(jcfg, opt, mesh, 2, donate=False)
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
        merged = jpl.merge_pipeline_params(
            jax.tree.map(np.asarray, state.params), jcfg, 2)
    finally:
        runtime.set_spmd_lowering(False)
    return (float(m["sum_loss"]) / float(m["ntokens"]),
            state_dict_from_flax(merged, CFG))


def _held(got, case, want_losses, want, n_model):
    for per_rank in got[:n_model]:
        np.testing.assert_allclose(per_rank[case][0], want_losses,
                                   rtol=1e-4 if n_model == 2 and case == 0
                                   else 1e-5)
    assert all(per_rank[case] is None for per_rank in got[n_model:])
    merged = got[0][case][2]
    assert merged.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(merged[k], np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_pipelined_step_matches_jax_pp_step(pipelined):
    cases, got = pipelined
    loss, want = _jax_pp_step(cases[0][1], MT[0][1])
    _held(got, 0, [loss], {k: v.numpy() for k, v in want.items()}, 2)


@pytest.mark.parametrize("case", [1, 2], ids=["mass", "packed"])
def test_pipelined_mass_and_packed_steps_match_one_process(pipelined, case):
    cases, got = pipelined
    losses, want = _one_process(CFG, cases[case][1], cases[case][6])
    _held(got, case, losses, want, 2)


def test_pipelined_steps_match_one_process_at_1x4(pipelined):
    """6 + 3 layers over four stages: the last holds no decoder layer; each
    rank holds the rest and its stage's layers, nothing else."""
    cases, got = pipelined
    losses, want = _one_process(DEEP, cases[3][1], MT)
    _held(got, 3, losses, want, 4)
    for r, per_rank in enumerate(got):
        names = per_rank[3][1]
        for kind, n in (("encoder.encoder", 6), ("decoder.decoder", 3)):
            mine = sorted({int(k.split(".")[3]) for k in names
                           if k.startswith(kind)})
            assert mine == list(pl.stage_layers(n, 4, r))
    assert not any(k.startswith("decoder.decoder") for k in got[3][3][1])


@pytest.mark.slow
def test_pipelined_steps_with_zero_match_one_process(tmp_path):
    """ZeRO-1 under the pipeline at 2x2: two steps of the 6 + 3 model
    against one process. Slow: a spawn of four ranks (~15 s)."""
    deep = random_params(DEEP, 0)
    got = run_ranks(ranks.pipeline_steps, 4, str(tmp_path / "store"),
                    ([(DEEP, deep, 2, 2, 2, True, MT)], OPT))
    losses, want = _one_process(DEEP, deep, MT)
    _held(got, 0, losses, want, 4)


def test_pipeline_refusals():
    """JAX's refusals: a model axis of 1, per-language decoders, proposal
    attention."""
    from imagetranslate_tpu_torch.parallel.mesh import ProcessMesh

    with pytest.raises(ValueError, match="model-axis size > 1"):
        pl.check_pipeline(CFG, ProcessMesh(2, 1))
    for kw in ({"lang_dec": True}, {"use_proposals": True}):
        with pytest.raises(ValueError, match="shared-decoder model"):
            pl.check_pipeline(dataclasses.replace(CFG, **kw),
                              ProcessMesh(1, 2))


# ---------------- the CLI under torchrun ----------------

WORDS = ["alpha", "beta", "gamma", "delta", "epsi", "zeta", "eta", "theta"]


@pytest.mark.slow
def test_cli_zero_pipeline_and_experts_under_torchrun(tmp_path):
    """``cli.train_mt`` under torchrun with each 14b flag for two steps:
    ``--mesh 2x1 --zero``, ``--mesh 1x2 --pp-microbatches 2`` (with a dev
    decode on the gathered model), ``--mesh 1x2 --moe-experts 2``; the
    pipelined run's checkpoint (weights and step) translates with
    ``cli.translate`` in one process, and ``--cont`` with
    ``--pp-microbatches`` is refused.
    Slow: three torchrun launches of two ranks (~15 s on 8 CPU cores)."""
    import os
    import subprocess
    import sys

    from imagetranslate_tpu_torch.cli.train_mt import main as train
    from imagetranslate_tpu_torch.cli.translate import main as translate
    from imagetranslate_tpu_torch.data import binarize
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train import checkpoint as ckpt

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
    common = ["--tok", str(tmp_path / "tok"), "--train_mt",
              str(tmp_path / "train.mt"), "--embed", "48", "--intermediate",
              "64", "--enc", "2", "--dec", "2", "--batch", "1200", "--lr",
              "0.005", "--warmup", "20", "--dtype", "float32", "--step", "2",
              "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    for name, flags in (
            ("zero", ["--mesh", "2x1", "--zero"]),
            ("pp", ["--mesh", "1x2", "--pp-microbatches", "2", "--dev_mt",
                    str(tmp_path / "train.mt"), "--beam", "2"]),
            ("moe", ["--mesh", "1x2", "--moe-experts", "2"])):
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m",
             "imagetranslate_tpu_torch.cli.train_mt", "--model",
             str(tmp_path / name), *common, *flags],
            env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        assert "Finished Training!" in proc.stdout
        meta = ckpt.load_checkpoint(str(tmp_path / name) + ".latest",
                                    with_opt_state=True)
        assert meta[2]["step"] == 2
        assert (meta[1] is None) == (name == "pp")    # PP: weights + step
    assert (tmp_path / "pp" / "bleu.output").exists()
    translate(["--tok", str(tmp_path / "tok"), "--model",
               str(tmp_path / "pp") + ".latest", "--input",
               str(tmp_path / "train.src"), "--src", "aa", "--target", "bb",
               "--batch", "100", "--device", "cpu", "--output",
               str(tmp_path / "pp.out")])
    assert len((tmp_path / "pp.out").read_text().splitlines()) == 60
    with pytest.raises(SystemExit, match="--cont with --pp-microbatches"):
        train(["--model", str(tmp_path / "again"), *common, "--mesh", "1x2",
               "--pp-microbatches", "2", "--pretrained",
               str(tmp_path / "pp") + ".latest", "--cont"])
