"""The harness on the CPU: BENCHMARK.json's form, finding items by name,
the arithmetic of the rate, the tail, the idle share and the operation
count, the refusal without a card, and what the harness may import."""

from __future__ import annotations

import ast
import json
import math
import os
import re
import shutil
import sys
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import catalog, flops, layer, names, run, trace  # noqa: E402
from portbench.paths import convert  # noqa: E402
from portbench.reference.models import Generator  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = catalog.benchmark()
HERE = os.path.join(ROOT, "portbench")


def test_benchmark_json_has_the_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    items = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for item in items:
        assert NAME.match(item["name"]), item["name"]
        for text in (item.get("why"), item.get("layer"), item.get("source")):
            assert text is None or (1 <= len(text) <= 200 and "\n" not in text and "\t" not in text)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in BENCH[group]]
        assert len(got) == len(set(got))
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_every_cell_has_its_files_and_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = catalog.cell(w["name"], BENCH)
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        assert {m["moves"] for m in cell["per_layer"]} <= {m["name"] for m in cell["end_to_end"]}
        assert cell["spec"]["limits"]
        catalog.load_module("paths", cell["traffic"]["path"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
    catalog.metric_readers(BENCH["per_layer"])
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_new_configuration_cell_and_metric_are_found_by_name(tmp_path, monkeypatch):
    """Files and entries alone add a cell: no edit of an existing file."""
    copy = tmp_path / "portbench"
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((copy / "configs" / "maskcyclegan-vc.json").read_text())
    (copy / "configs" / "maskcyclegan-vc-r128.json").write_text(json.dumps(
        {**cfg, "name": "maskcyclegan-vc-r128"}))
    (copy / "traffic" / "f32-b2x64.json").write_text(json.dumps(
        {**json.loads((copy / "traffic" / "f32-b1x64.json").read_text()), "batch": 2}))
    (copy / "workloads" / "train-f32-b2x64.json").write_text(json.dumps(
        {"config": "maskcyclegan-vc-r128", "traffic": "f32-b2x64", "chips": 1, "why": "a test",
         "control": {}, "limits": {"loss1_gap": 1.0}}))
    (copy / "metrics" / "train.launch_gaps.py").write_text(
        'LAYER = "device"\nUNIT = "count"\nBETTER = "lower"\nMOVES = "train_audio_s_per_s"\n\n'
        "def read(ctx):\n    return len(ctx.events)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "maskcyclegan-vc-r128",
                             "source": "https://arxiv.org/abs/2102.12841",
                             "file": "portbench/configs/maskcyclegan-vc-r128.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "train-f32-b2x64", "config": "maskcyclegan-vc-r128",
                               "traffic": "f32-b2x64", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_audio_s_per_s":
            m["workloads"].append("train-f32-b2x64")
    bench["per_layer"].append({"name": "train.launch_gaps", "unit": "count", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "train_audio_s_per_s", "workloads": ["train-f32-b2x64"]})
    monkeypatch.setattr(catalog, "HERE", str(copy))
    cell = catalog.cell("train-f32-b2x64", bench)
    assert cell["config"]["name"] == "maskcyclegan-vc-r128" and cell["traffic"]["batch"] == 2
    assert [m["name"] for m in cell["per_layer"]] == ["train.launch_gaps"]
    reader = catalog.metric_readers(cell["per_layer"])["train.launch_gaps"]
    assert reader.read(types.SimpleNamespace(events=[("k", 0.0, 1.0)] * 3)) == 3


def test_rate_counts_a_stalled_window_and_p95_is_of_every_request(monkeypatch):
    """The conversion window's rate is over all its time, a stall included,
    and its tail is over every request."""
    path = convert.Path.__new__(convert.Path)
    path.spans = {"generator": [], "vocoder": []}
    lat = iter([0.01] * 18 + [0.25] + [0.01] * 1000)
    clock, taken = {"t": 0.0}, []

    def utterance(self, i):
        dt = next(lat)
        taken.append(dt)
        clock["t"] += dt
        self.audio_s += 0.1
        return dt

    monkeypatch.setattr(convert.Path, "_utterance", utterance)
    monkeypatch.setattr(convert.time, "perf_counter", lambda: clock["t"])
    out = path.window(0.5)
    n = out["attempted"]
    assert n == len(taken) > 20 and 0.25 in taken and clock["t"] >= 0.5
    assert math.isclose(out["metrics"]["convert_audio_s_per_s"], n * 0.1 / clock["t"])
    lats = sorted(taken)  # the linear 95th percentile of every request
    pos = 0.95 * (n - 1)
    lo = int(pos)
    want = 1e3 * (lats[lo] + (pos - lo) * (lats[lo + 1] - lats[lo]))
    assert math.isclose(out["metrics"]["convert_p95_ms"], want)


def test_idle_share_is_from_the_union_of_overlapping_intervals():
    events = [("a", 0.0, 400.0), ("b", 100.0, 200.0), ("c", 350.0, 150.0), ("d", 800.0, 100.0)]
    assert math.isclose(trace.union_s(events), 600e-6)
    ctx = types.SimpleNamespace(events=events, window_s=1e-3)
    assert math.isclose(layer.idle_pct(ctx), 40.0)
    assert trace.gaps(events) == [(500.0, 300.0)]


def test_a_roofline_is_void_where_a_kernel_it_expects_is_not_traced():
    """A kernel renamed away from its pattern voids the reading; one that
    the yardstick expects no launch of is left out."""
    events = [("ps_in_swish_kernel<float>", 0.0, 40.0), ("ps_in_swish_kernel<float>", 50.0, 40.0)]
    ctx = types.SimpleNamespace(events=events, bound_s={"ps_in_swish": 40e-6, "in": 1e-6},
                                launches={"ps_in_swish": 2, "in": 0})
    assert math.isclose(layer.roofline_pct(ctx, ("ps_in_swish", "in")), 50.0)
    ctx.launches["in"] = 3
    assert layer.roofline_pct(ctx, ("ps_in_swish", "in")) is None
    del ctx.launches["in"]
    assert layer.roofline_pct(ctx, ("ps_in_swish", "in")) is None
    ctx.launches["ps_in_swish"] = 3
    assert layer.roofline_pct(ctx, ("ps_in_swish",)) is None


def test_flop_count_matches_one_conv_counted_by_hand():
    with torch.device("meta"):
        g = Generator(80, 256)
    x = torch.empty((1, 2, 80, 64), device="meta")
    with flops.FlopCounterMode(display=False) as counter:
        torch.nn.functional.conv2d(x, g.conv1.weight, g.conv1.bias, 1, (2, 7))
    assert counter.get_total_flops() == 2 * (128 * 80 * 64) * (2 * 5 * 15)


def test_a_run_without_a_card_fails_and_prints_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "train-f32-b1x64", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def _imports(path: str):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(HERE) for f in fs if f.endswith(".py")]
    assert len(files) > 20
    for path in files:
        found = set(_imports(path))
        assert not found & set(run.FORBIDDEN), (path, found)
        if os.sep + "reference" + os.sep in path:
            assert "maskcyclegan_vc_tpu_torch" not in found, path


def test_the_loaded_module_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "maskcyclegan_vc_tpu_torch_fake", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", types.ModuleType("flax.core"))
    assert run.forbidden_modules() == ["flax"]


def test_group_names_sort_the_kernels():
    assert names.group("void in_staged_kernel<float, (Epilogue)2, 4>(...)") == "kernels"
    assert names.group("sm90_xmma_fprop_implicit_gemm_bf16") == "conv"
    assert names.group("void at::native::multi_tensor_apply_kernel<...>") == "adam"
    assert names.group("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "collective"
    assert names.group("void at::native::elementwise_kernel<128, 4>") == "eager"
