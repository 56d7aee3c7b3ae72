"""A whole run, with the look for a card skipped (a CPU rehearsal at a tiny
width), and the timed path broken underneath: ``correct`` comes out false
for each fault that a cell can have and for the cell's control, and the
fault moves a compared number to three times or more its sound reading."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import catalog, run  # noqa: E402

SEED = 2 ** 31 + 5


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def rehearse(name: str, fault=None, control=None, seconds: float = 0.5,
             dtype=None) -> dict:
    cell = run.shrink(catalog.cell(name))
    if dtype is not None:
        cell = {**cell, "traffic": {**cell["traffic"], "dtype": dtype}}
    if control is not None:
        cell = {**cell, "spec": {**cell["spec"], "control": control}}
    r = run.Run(cell, SEED, torch.device("cpu"), control=control is not None, fault=fault)
    return run.execute(r, seconds)


def numbers(result: dict) -> dict:
    return {k: v["value"] for k, v in result["compared"].items()}


def assert_caught(broken: dict, sound: dict) -> None:
    assert broken["correct"] is False
    b, s = numbers(broken), numbers(sound)
    assert any(b[k] >= 3 * s[k] for k in b), (b, s)


@pytest.mark.parametrize("name,fault", [("train-bf16-b32x128", "unchanged"),
                                        ("train-bf16-b32x128", "half_batch"),
                                        ("train-f32-b1x64", "unchanged")])
def test_a_training_fault_is_not_correct(name, fault):
    """In f32: bf16's rounding at this tiny width on the CPU reads as much
    as the faults do; the faults break the step whatever its dtype."""
    assert_caught(rehearse(name, fault=fault, dtype="float32"), rehearse(name, dtype="float32"))


def test_an_altered_conversion_is_not_correct():
    sound = rehearse("convert-melgan-f32")
    assert sound["correct"] is True and sound["attempted"] > 0
    assert_caught(rehearse("convert-melgan-f32", fault="altered"), sound)


@pytest.mark.parametrize("name", ["convert-melgan-f32", "train-f32-b1x64"])
def test_the_reference_at_tf32_in_the_programs_place_is_not_correct(name):
    """On the card an f32 cell's control is the program with TF32 on, which
    the CPU cannot run; here the reference computes in TF32 in its place."""
    assert_caught(rehearse(name, control={"reference_operands": "tf32"}), rehearse(name))


def test_the_fp8_control_of_a_bf16_cell_is_not_correct():
    """The sound side in f32, as for the faults above: the control's own
    numbers do not depend on the program's dtype."""
    name = "train-bf16-b32x128"
    control = catalog.cell(name)["spec"]["control"]
    assert_caught(rehearse(name, control=control, dtype="float32"),
                  rehearse(name, dtype="float32"))


DP_CELL = "train-dp4-bf16-b1x64"


def _dp(fault=None) -> dict:
    cmd = [sys.executable, os.path.join(ROOT, "portbench", "run.py"), "--workload", DP_CELL,
           "--seed", str(SEED), "--seconds", "0.1", "--rehearse_cpu"]
    if fault:
        cmd += ["--fault", fault]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_exchange_between_ranks_left_out_is_not_correct():
    """Four gloo ranks on the CPU, each training on its own row without
    the gradient all-reduce."""
    assert_caught(_dp("no_exchange"), _dp())
