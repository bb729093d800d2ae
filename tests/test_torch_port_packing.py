"""Sequence packing and the step profiler in the port against the JAX
package (imagetranslate_tpu/data/packing.py, utils/profiling.py), on the
CPU.

- ``pack_mt_examples`` gives the JAX package's batches byte for byte (mixed
  directions, truncation at ``max_seq_len``, a row budget that one example
  fills, tail batches padded to ``rows_per_batch``), the same
  ``packing_efficiency``, and ``PackedMTBatcher.shuffled`` the same order;
- the port's MT step on a packed batch equals its step on the same examples
  unpadded-and-bucketed (one example a row): the same loss sum and token
  count, gradients within 2e-6 + rtol 1e-4 (fp32 sums in another order),
  and each example's logits within 2e-5 of its own;
- ``cli.train_mt --pack --profile DIR`` trains 16 packed steps (the
  batcher's budgets shrunk for the CPU) and writes a trace of steps 10-15;
  ``StepProfiler`` and ``annotate`` stand alone.
"""

import json
import marshal
import os
import random

import numpy as np
import pytest
import torch

from imagetranslate_tpu.data import packing as jpacking
from imagetranslate_tpu_torch.data import packing
from imagetranslate_tpu_torch.models.config import tiny_config
from imagetranslate_tpu_torch.models.seq2seq import Seq2Seq
from imagetranslate_tpu_torch.train import step as pstep
from imagetranslate_tpu_torch.train.weights import (
    random_params,
    state_dict_from_flax,
)
from imagetranslate_tpu_torch.utils.profiling import StepProfiler, annotate

V = 48
FIELDS = ("src", "src_seg", "src_pos", "dst", "dst_seg", "dst_pos",
          "src_langs", "dst_langs")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: steady under the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _examples(seed, n, lo=3, hi=12, directions=((0, 1),)):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        s, d = directions[i * 7 // n % len(directions)]
        out.append(([rng.randrange(5, V) for _ in range(rng.randint(lo, hi))],
                    [rng.randrange(5, V) for _ in range(rng.randint(lo, hi))],
                    s, d))
    out.sort(key=lambda e: len(e[1]))
    return out


CASES = {
    "default_budgets": (dict(), _examples(0, 300, 20, 90)),
    "directions": (dict(src_budget=32, dst_budget=28, rows_per_batch=4),
                   _examples(1, 90, directions=((0, 1), (1, 0), (0, 1),
                                                (1, 2)))),
    "truncated": (dict(src_budget=24, dst_budget=24, rows_per_batch=3,
                       max_seq_len=10, pad_id=2), _examples(2, 40, 4, 30)),
    "one_a_row": (dict(src_budget=12, dst_budget=12, rows_per_batch=5),
                  _examples(3, 23, 7, 12)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_mt_examples_matches_jax(case):
    kw, examples = CASES[case]
    got = packing.pack_mt_examples(examples, **kw)
    want = jpacking.pack_mt_examples(examples, **kw)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for name in FIELDS:
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name
        assert g.n_examples == w.n_examples and g.n_tokens == w.n_tokens
    assert sum(b.n_examples for b in got) == len(examples)
    assert packing.packing_efficiency(got) == jpacking.packing_efficiency(
        want)


@pytest.mark.parametrize("seed", [0, 5])
def test_packed_batcher_shuffled_matches_jax(seed):
    kw, examples = CASES["directions"]
    batcher = packing.PackedMTBatcher(examples, **kw)
    jbatcher = jpacking.PackedMTBatcher(examples, **kw)
    assert len(batcher) == len(jbatcher) > 3
    order = [id(b) for b in batcher.shuffled(seed)]
    index = {id(b): i for i, b in enumerate(batcher)}
    jindex = {id(b): i for i, b in enumerate(jbatcher)}
    assert [index[i] for i in order] == [
        jindex[id(b)] for b in jbatcher.shuffled(seed)]
    assert [index[i] for i in order] != list(range(len(batcher)))


class _Recording:
    """An optimizer that keeps the gradients it is handed."""
    chain = ()

    def init(self, params):
        return None

    def update(self, grads, state, params):
        self.grads = [g.clone() for g in grads]


def _unpacked(examples):
    """One example a row, padded: the dict ``mt_batch_to_device`` makes."""
    S = max(len(e[0]) for e in examples)
    T = max(len(e[1]) for e in examples)
    n = len(examples)
    src, dst = np.zeros((n, S), np.int32), np.zeros((n, T), np.int32)
    for i, (s, d, _, _) in enumerate(examples):
        src[i, :len(s)], dst[i, :len(d)] = s, d
    langs = np.array([[e[2], e[3]] for e in examples], np.int32)
    return {"src": torch.tensor(src), "src_mask": torch.tensor(src > 0),
            "dst": torch.tensor(dst), "dst_mask": torch.tensor(dst > 0),
            "src_langs": torch.tensor(langs[:, 0]),
            "dst_langs": torch.tensor(langs[:, 1]),
            "row_mask": torch.ones(n, dtype=torch.bool)}


def test_packed_step_equals_unpacked_step_per_token():
    cfg = tiny_config(V)
    params = random_params(cfg, 0)
    examples = _examples(4, 9, 3, 9)
    (pk,) = packing.pack_mt_examples(examples, src_budget=24, dst_budget=20,
                                     rows_per_batch=4)
    assert pk.n_examples == 9 and (pk.dst_seg.max(1) > 1).any()
    runs = {}
    for name, batch in (("packed", pstep.packed_mt_batch_to_device(
            pk, torch.device("cpu"))), ("unpacked", _unpacked(examples))):
        model = Seq2Seq(cfg, param_dtype=torch.float32)
        model.load_state_dict(state_dict_from_flax(params, cfg))
        optim = _Recording()
        state = pstep.create_train_state(dict(model.named_parameters()),
                                         optim)
        step = pstep.make_mt_train_step(model, optim)
        _, m = step(state, batch, torch.Generator().manual_seed(0))
        runs[name] = (m, optim.grads, model, batch)
    (mp, gp, model, pb), (mu, gu, _, ub) = runs["packed"], runs["unpacked"]
    assert float(mp["ntokens"]) == float(mu["ntokens"]) == sum(
        len(e[1]) - 1 for e in examples)
    np.testing.assert_allclose(float(mp["sum_loss"]), float(mu["sum_loss"]),
                               rtol=1e-5)
    for name, a, b in zip(dict(model.named_parameters()), gp, gu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6,
                                   rtol=1e-4, err_msg=name)
    with torch.no_grad():
        packed_logits = model(
            pb["src"], pb["src_seg"] > 0, pb["dst"], pb["dst_seg"] > 0,
            pb["src_langs"], pb["dst_langs"], tgt_positions=pb["dst_pos"],
            src_positions=pb["src_pos"], src_segments=pb["src_seg"],
            tgt_segments=pb["dst_seg"])
        alone = model(ub["src"], ub["src_mask"], ub["dst"], ub["dst_mask"],
                      ub["src_langs"], ub["dst_langs"])
    # Packing order is the examples' order: row by row, segment by segment.
    i = 0
    for r in range(pk.dst.shape[0]):
        for seg in range(1, int(pk.dst_seg[r].max()) + 1):
            # Logits predict the next token: a segment's last slot
            # predicts across the boundary.
            at = np.nonzero(pk.dst_seg[r] == seg)[0][:-1]
            np.testing.assert_allclose(
                packed_logits[r, at].numpy(),
                alone[i, :len(at)].numpy(), atol=2e-5, rtol=1e-5)
            i += 1
    assert i == len(examples)


def test_step_profiler_writes_the_window(tmp_path):
    prof = StepProfiler(str(tmp_path / "p"), start=2, stop=4)
    x = torch.ones(8, 8)
    for step in range(1, 7):
        with annotate(f"step{step}"):
            x = x @ x / 8
        prof.tick(step)
        assert prof.active == (2 <= step < 4)
    prof.close()
    events = json.loads(open(prof.trace_path()).read())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "step3" in names and "step1" not in names and "step5" not in names
    # No directory: nothing happens; close() ends a window the loop left.
    StepProfiler(None, start=0).tick(0)
    open_window = StepProfiler(str(tmp_path / "q"), start=1, stop=100)
    open_window.tick(1)
    open_window.close()
    assert os.path.exists(open_window.trace_path())


def test_train_mt_cli_pack_and_profile(tmp_path, capsys, monkeypatch):
    """16 packed steps through the CLI, the first epoch profiled: the trace
    of steps 10-15 is written, and the checkpoint. The CLI packs rows of 256
    tokens, 64 a batch (the JAX CLI's budgets, which the tests above hold);
    here the batcher's budgets shrink to 8 rows of 48 tokens, as the
    plain attention's dropout masks at [64, 12, 256, 256] take ~40 s a step
    on one CPU thread. Phase 24 of chip_smoke.py runs the CLI's own shape on
    the card."""
    import functools

    from imagetranslate_tpu_torch.cli.train_mt import main
    from imagetranslate_tpu_torch.text.processor import TextProcessor
    from imagetranslate_tpu_torch.train import checkpoint as ckpt

    small = functools.partial(packing.PackedMTBatcher, rows_per_batch=8,
                              src_budget=48, dst_budget=48)
    monkeypatch.setattr(packing, "PackedMTBatcher", small)
    words = ["alpha", "beta", "gamma", "delta", "epsi", "zeta"]
    rng = random.Random(0)
    (tmp_path / "c.txt").write_text("\n".join(
        " ".join(rng.choice(words) for _ in range(6)) for _ in range(60)))
    TextProcessor().train_tokenizer([str(tmp_path / "c.txt")], 100,
                                    str(tmp_path / "tok"),
                                    {"<aa>": 0, "<bb>": 1})
    tp = TextProcessor(str(tmp_path / "tok"))
    vocab, sep = tp.vocab_size(), tp.sep_token_id()
    a, b = tp.token_id("<aa>"), tp.token_id("<bb>")
    examples = []
    for _ in range(400):
        body = [rng.randrange(5, vocab) for _ in range(rng.randint(4, 20))]
        examples.append(([a] + body + [sep], [b] + body + [sep], 0, 1))
    examples.sort(key=lambda e: len(e[1]))
    with open(tmp_path / "train.mt", "wb") as f:
        marshal.dump(examples, f)
    n_batches = len(small(examples))
    assert n_batches >= 16
    main(["--tok", str(tmp_path / "tok"), "--model", str(tmp_path / "m"),
          "--train_mt", str(tmp_path / "train.mt"), "--embed", "24",
          "--intermediate", "32", "--enc", "1", "--dec", "1", "--step", "16",
          "--warmup", "4", "--dtype", "float32", "--dropout", "0.1",
          "--pack", "--profile", str(tmp_path / "prof"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"MT train batches: {n_batches} (packed," in out
    assert out.count("train epoch") == 1         # 16 steps in epoch 0
    trace = tmp_path / "prof" / "trace_steps_10_15.json"
    assert trace.exists() and trace.stat().st_size > 0
    assert "traceEvents" in json.loads(trace.read_text())
    assert ckpt.load_checkpoint(str(tmp_path / "m") + ".latest")[2][
        "step"] == 16
