"""The port's recipe ladder (``cli.recipe_check``) on the CPU, on a generated
sample corpus (``make_sample_corpus``: a word-for-word substitution cipher of
20 made-up words, 5-7 words a line):

- a reduced ladder (the step counts, the learning rate and the dev size
  given as flags; every floor at its default: dev-loss drop 0.5, BLEU 0.1,
  MASS drop 0.2, back-translation NLL drop 0.02, caption drop 0.3) exits 0
  and appends a PASS row to the ledger;
- ``--lr 0`` exits 1 and appends the FAILED row with the failing assertion.
"""

import json

import pytest
import torch

from imagetranslate_tpu_torch.cli import recipe_check

pytest.importorskip("sacrebleu")
pytest.importorskip("PIL")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("sample")
    recipe_check.make_sample_corpus(str(d), n_lines=2200, n_words=20,
                                    lengths=(5, 7))
    return d


def _run(sample, tmp_path, capsys, *flags):
    ledger = tmp_path / "RECIPES.md"
    rc = recipe_check.main(["--sample-dir", str(sample), "--workdir",
                            str(tmp_path / "work"), "--ledger", str(ledger),
                            "--device", "cpu", "--dev-size", "32", *flags])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return rc, result, ledger.read_text()


def test_reduced_ladder_passes_at_the_default_floors(sample, tmp_path,
                                                     capsys):
    rc, result, ledger = _run(sample, tmp_path, capsys, "--steps", "60",
                              "--mass-steps", "8", "--bt-steps", "4",
                              "--cap-steps", "6", "--lr", "1e-3")
    assert rc == 0 and result["ok"], result
    sup, umt, cap = result["supervised"], result["umt"], result["caption"]
    assert sup["steps"] == 60 and sup["bleu"] >= 0.1
    assert sup["dev_loss_after"] < sup["dev_loss_before"] - 0.5
    assert umt["mass_loss_after"] < umt["mass_loss_before"] - 0.2
    assert umt["bt_steps"] == 4
    assert umt["bt_dev_nll_after"] < umt["bt_dev_nll_before"] - 0.02
    assert cap["loss_after"] < cap["loss_before"] - 0.3
    head, *rows = ledger.strip().splitlines()
    assert "PASS (cpu)" in head and len(rows) == 3
    assert rows[0].startswith("- **supervised**: steps=60, ")


def test_lr_0_fails_and_writes_the_failed_row(sample, tmp_path, capsys):
    rc, result, ledger = _run(sample, tmp_path, capsys, "--steps", "2",
                              "--lr", "0")
    assert rc == 1 and not result["ok"]
    assert "dev loss did not drop" in result["failure"]["message"]
    assert "FAIL (cpu)" in ledger and "- **failure**: message=" in ledger
