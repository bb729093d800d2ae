"""A whole run past the card check, on the CPU at tiny widths, with the
timed path broken underneath: ``correct`` comes out false for each fault a
cell can have (a step that leaves its state unchanged, half of the batch
left out with the mean over the rest, a served token altered where it is
produced, the beam's scores altered where they are produced), and true on
the sound path. The cells run on one card, so there
is no exchange between cards to leave out."""

import copy
import time

import pytest
import torch

import harness
import tiny

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def correct(name: str, seed: int = 2 ** 31 + 11, **config) -> dict:
    cell = tiny.tiny_cell(name)
    cell.config.update(config)
    out, checks = harness.run_cell(cell, seed, 0.2, False, CPU, time.time())
    out["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    return out, checks


@pytest.mark.parametrize("name", ["mt-train-packed", "mt-train-bucketed",
                                  "mt-translate-beam4", "caption-beam4"])
def test_sound_run_is_correct(name):
    out, checks = correct(name)
    assert out["correct"], checks
    assert out["attempted"] > 0 and out["failed"] == 0


def _faulty_step(monkeypatch, fault):
    from imagetranslate_tpu_torch.train import trainer_mt

    real_make = trainer_mt.make_mt_train_step

    def make(model, optimizer, label_smoothing=0.1):
        real = real_make(model, optimizer, label_smoothing=label_smoothing)

        def step_fn(state, batch, rng):
            return fault(real, state, batch, rng)

        return step_fn

    monkeypatch.setattr(trainer_mt, "make_mt_train_step", make)


def unchanged(real, state, batch, rng):
    params = {k: p.detach().clone() for k, p in state.params.items()}
    opt, step = copy.deepcopy(state.opt_state), state.step
    state, m = real(state, batch, rng)
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(params[k])
    state.opt_state, state.step = opt, step
    return state, m


def half_batch(real, state, batch, rng):
    rows = next(iter(batch.values())).shape[0] // 2
    return real(state, {k: v[:rows] for k, v in batch.items()}, rng)


@pytest.mark.parametrize("fault", [unchanged, half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", ["mt-train-packed", "mt-train-bucketed"])
def test_training_faults_are_caught(monkeypatch, name, fault):
    _faulty_step(monkeypatch, fault)
    out, checks = correct(name)
    assert not out["correct"], checks


@pytest.mark.parametrize("name", ["mt-translate-beam4", "caption-beam4"])
@pytest.mark.parametrize("what", ["token", "length"])
def test_altered_answers_are_caught(monkeypatch, name, what):
    from imagetranslate_tpu_torch.decoding import beam

    real = beam.beam_search

    def altered(*a, **kw):
        best, lengths = real(*a, **kw)
        best = best.clone()
        if what == "token":
            best[:, 2] = (best[:, 2] + 17) % 96
        else:
            lengths = lengths - 1
        return best, lengths

    monkeypatch.setattr(beam, "beam_search", altered)
    # Logits spread as the full model's do (std ~0.5 at 768 wide).
    out, checks = correct(name, initializer_range=0.1)
    assert not out["correct"], checks


@pytest.mark.parametrize("name", ["mt-translate-beam4", "caption-beam4"])
def test_altered_scores_are_caught(monkeypatch, name):
    """The projection's logsumexp shifted by 0.05 nats: every candidate's
    log-probability moves alike, so the beam serves the same tokens, and
    only the hypotheses' scores are wrong."""
    from imagetranslate_tpu_torch.ops import topk_project as tkp

    for attr in ("project_topk", "project_topk_reference"):
        real = getattr(tkp, attr)

        def shifted(*a, _real=real, **kw):
            val, idx, lse = _real(*a, **kw)
            return val, idx, lse + 0.05

        monkeypatch.setattr(tkp, attr, shifted)
    out, checks = correct(name)
    assert not out["correct"], checks
    assert checks["topk_gap"]["value"] <= checks["topk_gap"]["limit"]
