"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; the mix's ``kind`` names the code that runs it
(``traffic/<kind>.py``). Set-up makes the inputs and the weights from
``--seed`` and warms every shape the window uses; the window runs whole
passes of the mix until one ends after ``--seconds`` (so every run does the
same batches). ``--trace 1`` reads the per-layer metrics instead of the
end-to-end ones (after the untraced window, one pass of the traffic traced
with the device's activity alone, then a few steps traced with the host's
ops too, whose idle gaps the breakdown labels). Once the window has closed and the program's state is
freed, the plain reference checks a sample of what the window produced. The
last line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (``--trace 1``: with ``busy_s`` and
``window_s``), with ``--trace 1`` a ``breakdown``, and last ``checks``, each
compared number beside its limit. A run without the cell's cards exits 3 and
prints no result; a run that loaded JAX or the JAX package exits 4.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)

# Every cache the program or PyTorch keeps lies inside the checkout, at a
# fixed path (the kernels' library already builds into
# imagetranslate_tpu_torch/_build/).
_CACHE = os.path.join(ROOT, ".bench_cache")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_CACHE, "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(_CACHE, "ext"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser("benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    started = harness.process_start()

    cell = harness.load_cell(args.workload)
    harness.require_cards(cell.chips)
    import torch

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    harness.phase("torch and the card")
    out, checks = harness.run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), device, started)
    return harness.finish(out, checks)


if __name__ == "__main__":
    sys.exit(main())
