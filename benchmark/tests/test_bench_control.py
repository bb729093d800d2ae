"""The control: the plain reference computed one precision step below the
configurations' bfloat16 (fp8 e4m3 products) in the program's place must
come out as not correct, on the CPU at tiny widths here and at the cells'
own sizes on the card (``-m cuda``, three seeds). The program's own
readings stay under the limits."""

import pytest
import torch

import harness
import tiny
from judge import limits

CELLS = ["mt-train-packed", "mt-train-bucketed", "mt-translate-beam4",
         "caption-beam4"]


def fails(numbers, lim) -> bool:
    return any(v > lim[k] for k, v in numbers.items() if k in lim)


def holds(numbers, lim) -> bool:
    return all(v <= lim[k] for k, v in numbers.items() if k in lim)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_cpu(name):
    torch.set_num_threads(2)
    cell = tiny.tiny_cell(name)
    cell.config.update(tiny.TINY_CONTROL[name])
    got = harness.kind_module(cell).control(cell, 2 ** 31 + 21,
                                            torch.device("cpu"), faults=True)
    lim = limits(name)
    assert holds(got["program"], lim), got
    assert fails(got["control_fp8"], lim), got
    if "half_batch" in got:
        assert fails(got["half_batch"], lim), got


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the cells' sizes run there only")
    cell = harness.load_cell(name)
    got = harness.kind_module(cell).control(cell, seed,
                                            torch.device("cuda", 0),
                                            faults=True)
    lim = limits(name)
    assert holds(got["program"], lim), got
    assert fails(got["control_fp8"], lim), got
