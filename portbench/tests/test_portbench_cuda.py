"""On the card: the control, answers rounded to TF32 (the precision below
the configurations' float32), comes out not correct at the cells' traffic
with a batch a test run holds; the same run without it is correct.

    python -m pytest portbench/tests/test_portbench_cuda.py -m cuda
"""
import pytest

from portbench.harness import bench, registry
from portbench.harness.control import rounded_answers

BENCH = registry.load_benchmark()


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cstr_fleet_warm", "cstr_sample_cold"])
@pytest.mark.parametrize("control", [False, True])
def test_control_is_not_correct_on_the_card(cell, control):
    _card()
    c = registry.Cell(BENCH, cell)
    result, compared = bench.run_cell(
        c, 2 ** 31 + 101, 2.0, False, batch=128,
        program_hook=rounded_answers if control else None,
        log=lambda rec: None)
    assert result["correct"] is (not control), compared
    assert result["device"]["platform"] == "gpu"
