"""The HiFi-GAN conversion cell on the CPU: it resolves by name with the two
conversion metrics, the conversion cells' per-layer metrics (all but K9's
roofline) and the HiFi-GAN's roofline; a whole run at a tiny
width (the CPU rehearsal's, and 32 initial channels) is correct, and its
``altered`` fault and the reference at TF32 in the program's place are not;
each of its metric readers finds nothing in an empty context; the work
count of a V1 decode."""

from __future__ import annotations

import os
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import catalog, hifigan_work, run  # noqa: E402

CELL = "convert-hifigan-v1-f32"
SEED = 2 ** 31 + 13
METRICS = ("convert.device_idle_pct", "convert.generator_p50_ms", "convert.generator_idle_ms",
           "convert.mfu_pct", "convert.vocoder_p50_ms", "convert.vocoder_idle_ms",
           "hifigan.vocoder_roofline_pct")


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_the_cell_resolves_with_its_metrics():
    cell = catalog.cell(CELL)
    assert cell["chips"] == 1 and cell["traffic"]["path"] == "convert_hifigan"
    assert cell["config"]["hifigan"]["params"] == 13_926_017
    assert {m["name"] for m in cell["end_to_end"]} == {"convert_audio_s_per_s",
                                                       "convert_p95_ms", "setup_s"}
    assert sorted(m["name"] for m in cell["per_layer"]) == sorted(METRICS)
    assert set(cell["spec"]["limits"]) == {"mel_gap", "wav_gap"}
    assert cell["spec"]["control"] == {"program_precision": "tensorfloat32"}


def rehearse(fault=None, control=None) -> dict:
    cell = run.shrink(catalog.cell(CELL))
    cfg = {**cell["config"], "hifigan": {**cell["config"]["hifigan"],
                                         "upsample_initial_channel": 32}}
    cell = {**cell, "config": cfg}
    if control is not None:
        cell = {**cell, "spec": {**cell["spec"], "control": control}}
    r = run.Run(cell, SEED, torch.device("cpu"), control=control is not None, fault=fault)
    return run.execute(r, 0.5)


def _numbers(result: dict) -> dict:
    return {k: v["value"] for k, v in result["compared"].items()}


@pytest.mark.parametrize("broken", [{"fault": "altered"},
                                    {"control": {"reference_operands": "tf32"}}])
def test_a_sound_run_is_correct_and_the_fault_and_the_control_are_not(broken):
    """On the card the control is the program with TF32 on, which the CPU
    cannot run; here the reference computes in TF32 in its place."""
    sound = rehearse()
    assert sound["correct"] is True and sound["attempted"] > 0
    got = rehearse(**broken)
    assert got["correct"] is False
    b, s = _numbers(got), _numbers(sound)
    assert any(b[k] >= 3 * s[k] for k in b), (b, s)
    if "fault" in broken:
        assert all(b[k] > got["compared"][k]["limit"] for k in b), b


@pytest.mark.parametrize("name", METRICS)
def test_each_reader_finds_nothing_in_an_empty_context(name):
    ctx = types.SimpleNamespace(events=[], host=[], units=0, window_s=0.0, spans={}, flops=0.0,
                                vocoder_flops=0.0, peak_flops=67e12, vocoder_device_s=None,
                                bound_s={}, launches={})
    assert catalog.metric_readers([m for m in catalog.cell(CELL)["per_layer"]
                                   if m["name"] == name])[name].read(ctx) is None


def test_the_work_of_a_v1_decode():
    """614.1 MFLOP a mel frame for the vocoder (2 x MACs of its convs)."""
    cfg = catalog.read_json("configs", "maskcyclegan-vc-hifigan-v1")
    work = hifigan_work.conversion(cfg, 100)
    assert work["vocoder"] == 100 * 614_105_088
    assert work["generator"] > 0
