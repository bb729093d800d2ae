"""No run loads JAX or the JAX package, and the plain reference imports
nothing of the program; a run without a card fails and prints no result."""

import ast
import glob
import json
import os
import subprocess
import sys

import harness

BENCH = harness.HERE


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(BENCH, "reference", "*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".", 1)[0]
            assert top not in harness.FORBIDDEN + ("imagetranslate_tpu_torch",
                                                   "jax"), (path, name)


def test_no_benchmark_file_imports_jax():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        for name in _imports(path):
            assert name.split(".", 1)[0] not in harness.FORBIDDEN, (path,
                                                                    name)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "imagetranslate_tpu_torch_x", sys)
    assert "imagetranslate_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert "flax" in harness.forbidden_modules()


DRY_RUN = r"""
import sys
sys.path[:0] = [{bench!r}, {root!r}, {tests!r}]
import torch, harness, tiny
cell = tiny.tiny_cell({cell!r})
harness.kind_module(cell).run(cell, 5, 0.2, False, torch.device("cpu"))
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}))
print("FORBIDDEN", harness.forbidden_modules())
"""


def test_a_dry_run_loads_no_jax():
    code = DRY_RUN.format(bench=BENCH, root=harness.ROOT,
                          tests=os.path.dirname(__file__),
                          cell="mt-translate-beam4")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "imagetranslate_tpu_torch" in lines[-2]
    assert lines[-1] == "FORBIDDEN []"


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "mt-train-packed", "--seed", str(2 ** 31 + 9), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        env=env, cwd=harness.ROOT)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            parsed = json.loads(line)
        except ValueError:
            continue
        assert "metrics" not in parsed
    assert "no CUDA card" in out.stderr
