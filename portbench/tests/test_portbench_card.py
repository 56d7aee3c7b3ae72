"""On the card, at the published widths with a short window and a short
conversion cycle: a sound run of each f32 cell is correct, and its control
(the program with TF32 on) is not.

    python -m pytest --noconftest portbench/tests/test_portbench_card.py -q

Marked ``cuda``; skipped where PyTorch sees no card (decided in a fixture).
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import catalog, run  # noqa: E402

SEED = 2 ** 31 + 9


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda", 0)


def short(cell: dict) -> dict:
    tr = dict(cell["traffic"])
    if tr["path"] == "convert":
        tr.update(count=8, keep_one_in=2)
    return {**cell, "traffic": tr}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["convert-melgan-f32", "train-f32-b1x64"])
def test_sound_run_is_correct_and_its_control_is_not(card, name):
    cell = short(catalog.cell(name))
    sound = run.execute(run.Run(cell, SEED, card), 1.0)
    control = run.execute(run.Run(cell, SEED, card, control=True), 1.0)
    assert sound["correct"] is True, sound["compared"]
    assert control["correct"] is False, control["compared"]
