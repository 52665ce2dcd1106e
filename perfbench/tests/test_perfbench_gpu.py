"""On the card: each cell's control (the reference put in the program's place one
precision down) fails the cell's limits, and a sound run of the program passes
them, at the cell's widths with less data than a run holds.

    python -m pytest -q -m gpu perfbench/tests/test_perfbench_gpu.py
"""

import pytest
import torch
from conftest import CELLS

from perfbench.harness import Cell

SMALLER = {
    "train": {"sequences": 20, "frames_per_sequence": 600},
    "eval": {"subjects": 1, "actions": 2, "takes": 1, "cameras": 2, "min_frames": 1000,
             "max_frames": 1500},
    "stream": {"track_frames": 512, "control_dispatches": 1000},
}
SEEDS = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _driver(name, seed, device):
    cell = Cell(name)
    cell.traffic = {**cell.traffic, **SMALLER[cell.traffic["driver"]]}
    drv = cell.driver(seed, device)
    drv.setup()
    return cell, drv


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name, seed):
    cell, drv = _driver(name, seed, card)
    drv.window(1.0)
    drv.free()
    torch.cuda.empty_cache()
    sound = drv.check()
    assert all(sound[k] <= lim["limit"] for k, lim in cell.limits.items()), sound
    extra = [cell.traffic["control_dispatches"]] if cell.traffic["driver"] == "stream" else []
    control = drv.control(*extra)
    assert any(control[k] > lim["limit"] for k, lim in cell.limits.items() if k in control), \
        control
