"""Read the numbers ``correct`` compares, without a timed window, on many
seeds in one process: the program's (which set each limit's lower
reading), and on the first ``--faults`` seeds the control's (the plain
reference in fp8, the step below the configurations' bfloat16) and, for a
training cell, the fault of half the batch left out (which set the upper
readings).

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 ... \
        --faults 3

One JSON line a seed, then the largest program reading and the smallest
control and fault readings of each number. The limits in
``limits/<cell>.json`` are set between them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser("control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", type=int, default=3)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.require_cards(cell.chips)
    import torch

    device = torch.device("cuda", 0)
    kind = harness.kind_module(cell)
    lowest, highest = {}, {}
    for i, seed in enumerate(args.seeds):
        got = kind.control(cell, seed, device, faults=i < args.faults)
        print(json.dumps({"seed": seed, **got}), flush=True)
        for arm, numbers in got.items():
            for name, v in numbers.items():
                key = f"{arm}.{name}"
                highest[key] = max(highest.get(key, v), v)
                lowest[key] = min(lowest.get(key, v), v)
    print(json.dumps({"workload": cell.name, "largest": highest,
                      "smallest": lowest}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
