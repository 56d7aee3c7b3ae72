"""The port's span recorder (``obs/profiler.py``: ``span``, ``RECORDER``)
on the CPU: nesting, causes and request ids; the ring's eviction beside
totals that stay; a span touching no tensor; the span names of the CPU
paths of ``StepRunner.run``, ``make_convert_fn``, ``decode_mel`` and one
``Trainer`` epoch; the spans in ``trace``'s Chrome trace and on the
profiler's clock; and ``portbench/spans.py``, which reads them against a
traced slice, on synthetic events.
"""

import glob
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode

from maskcyclegan_vc_tpu_torch.cli.test import make_convert_fn
from maskcyclegan_vc_tpu_torch.data.dataset import save_speaker
from maskcyclegan_vc_tpu_torch.models import Generator
from maskcyclegan_vc_tpu_torch.models.melgan import MelGANGenerator, decode_mel
from maskcyclegan_vc_tpu_torch.obs import profiler
from maskcyclegan_vc_tpu_torch.obs.logger import TrainLogger
from maskcyclegan_vc_tpu_torch.train.trainer import Trainer, TrainerArgs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import spans as pspans  # noqa: E402

N_MELS, R = 16, 8


def _since(t_ns):
    return [sp for sp in profiler.spans() if sp.start_ns >= t_ns]


# ---------- the recorder ----------

def test_spans_nest_with_their_cause_and_request():
    rec = profiler.Recorder()
    with rec.span("utterance", request=7) as utt:
        with rec.span("convert") as conv:
            with rec.span("convert.h2d") as h2d:
                pass
        with rec.span("decode", request=8) as dec:
            pass
    with rec.span("other") as other:
        pass
    assert [sp.name for sp in rec.spans()] == ["convert.h2d", "convert", "decode",
                                              "utterance", "other"]
    assert (utt.cause, conv.cause, h2d.cause, dec.cause, other.cause) == \
        (None, utt.id, conv.id, utt.id, None)
    # A span without a request takes its cause's; one given keeps its own.
    assert (conv.request, h2d.request, dec.request, other.request) == (7, 7, 8, None)
    assert len({utt.id, conv.id, h2d.id, dec.id, other.id}) == 5
    for sp in (utt, conv, h2d, dec):
        assert sp.start_ns <= sp.end_ns
    assert utt.start_ns <= conv.start_ns <= h2d.start_ns <= h2d.end_ns <= conv.end_ns \
        <= dec.start_ns <= dec.end_ns <= utt.end_ns
    assert rec.last("convert") == (conv.name, conv.request, conv.id, conv.cause, conv.start_ns,
                                   conv.end_ns)
    assert rec.last("missing") is None
    assert rec.totals()["utterance"] == (1, utt.seconds)


def test_the_ring_evicts_the_oldest_and_the_totals_stay():
    rec = profiler.Recorder(size=4)
    with rec.span("setup"):
        pass
    for i in range(10):
        with rec.span("step", request=i):
            pass
    rec.count("kernels.built", 3)
    rec.count("kernels.built")
    kept = rec.spans()
    assert [sp.request for sp in kept] == [6, 7, 8, 9]
    totals = rec.totals()
    assert totals["setup"][0] == 1 and totals["step"][0] == 10
    assert totals["step"][1] >= sum(sp.seconds for sp in kept)
    assert rec.counters() == {"kernels.built": 4}


def test_a_span_touches_no_tensor():
    """Entering and leaving spans runs no aten operation: nothing to launch,
    synchronise or capture."""
    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(func)
            return func(*args, **(kwargs or {}))

    with Ops() as ops:
        with profiler.span("outer", request=1):
            with profiler.span("inner"):
                pass
        x = torch.ones(2) + 1
    assert len(ops.seen) == 2 and float(x.sum()) == 4.0  # the ones and the add only


def test_threads_nest_their_own_spans():
    import threading

    rec = profiler.Recorder()
    wrong = []

    def work(tag):
        with rec.span(tag) as outer:
            for _ in range(200):
                with rec.span(f"{tag}.inner") as inner:
                    if inner.cause != outer.id:
                        wrong.append(tag)

    threads = [threading.Thread(target=work, args=(f"t{i}",)) for i in range(6)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not wrong
    totals = rec.totals()
    assert all(totals[f"t{i}.inner"][0] == 200 for i in range(6))
    assert len(rec.spans()) == 6 * 201


# ---------- the program's spans on the CPU paths ----------

def test_convert_and_decode_record_their_spans():
    gen = Generator(n_mels=N_MELS, residual_channels=R, device="cpu").eval()
    voc = MelGANGenerator(N_MELS, 4, device="cpu").eval()
    convert = make_convert_fn(gen)
    t0 = time.time_ns()
    with profiler.span("utterance", request=3):
        fake = convert(np.random.RandomState(0).randn(N_MELS, 40).astype(np.float32))
        with torch.inference_mode():
            decode_mel(voc, fake[None], np.zeros((N_MELS, 1)), np.ones((N_MELS, 1)))
    got = _since(t0)
    assert [sp.name for sp in got] == ["convert.h2d", "convert.generator", "convert.d2h",
                                       "convert", "decode.h2d", "decode.vocoder", "decode",
                                       "utterance"]
    by = {sp.name: sp for sp in got}
    assert all(sp.request == 3 for sp in got)
    for child, parent in (("convert.h2d", "convert"), ("convert.d2h", "convert"),
                          ("convert", "utterance"), ("decode.h2d", "decode"),
                          ("decode", "utterance")):
        assert by[child].cause == by[parent].id


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans_train")
    rs = np.random.RandomState(0)
    for sid in ("VCC2SF3", "VCC2TF1"):
        save_speaker(str(root / "pre"), sid,
                     [rs.randn(N_MELS, t).astype(np.float32) for t in (20, 31, 40)],
                     rs.randn(N_MELS, 1).astype(np.float32),
                     (rs.rand(N_MELS, 1) + 0.5).astype(np.float32))
    return root


def test_one_trainer_epoch_records_its_spans_and_logs_them(corpus):
    trainer = Trainer(TrainerArgs(
        name="spans", save_dir=str(corpus / "results"), preprocessed_data_dir=str(corpus / "pre"),
        num_epochs=1, batch_size=1, num_frames=16, n_mels=N_MELS, residual_channels=R,
        epochs_per_save=1, epochs_per_plot=1, steps_per_print=1, plot_audio="off",
        async_save=False, device="cpu"))
    t0 = time.time_ns()
    trainer.train()
    got = _since(t0)
    names = [sp.name for sp in got]
    steps = trainer.steps_per_epoch
    assert names.count("train.inputs") == steps and names.count("train.run") == 1
    assert names.count("convert") == 2  # the plot's two conversions
    assert names[-1] == "train.epoch" and got[-1].request == 1
    by = {sp.name: sp for sp in got}
    epoch = by["train.epoch"]
    for name in ("train.run", "train.readback", "train.plot", "train.save"):
        assert by[name].cause == epoch.id, name
    assert [sp.request for sp in got if sp.name == "train.inputs"] == list(range(steps))
    assert all(sp.cause == by["train.run"].id for sp in got if sp.name == "train.inputs")
    assert by["convert"].cause == by["train.plot"].id
    assert profiler.totals()["train.create_state"][0] >= 1
    log = open(corpus / "results" / "spans" / "spans.log").read().splitlines()
    setup = [line for line in log if line.startswith("[setup]")]
    assert len(setup) == 1 and "kernels" in setup[0] and "state" in setup[0]
    done = [line for line in log if line.startswith("epoch 1 done in")]
    assert len(done) == 1
    for part in ("read-back", "plot", "save"):
        assert f"{part} " in done[0] and " ms" in done[0]
    # ms/it: the run and its read-back over the epoch's steps.
    step_ms = 1e3 * (by["train.run"].seconds + by["train.readback"].seconds) / steps
    its = [float(line.rsplit("(", 1)[1].split()[0]) for line in log if line.startswith("[epoch")]
    assert len(its) == steps and its == pytest.approx([step_ms] * steps, abs=0.051)


def test_logger_ms_per_it_is_the_mean_of_the_steps_given(tmp_path):
    logger = TrainLogger(str(tmp_path), "log", steps_per_print=2, use_tensorboard=False)
    for step, s in ((1, 0.010), (2, 0.030), (3, 0.002), (4, 0.004)):
        logger.log_iter(step, 1, {"g_loss": 1.0}, seconds=s)
    lines = open(tmp_path / "log" / "log.log").read().splitlines()
    assert [line.rsplit("(", 1)[1] for line in lines] == ["20.0 ms/it)", "3.0 ms/it)"]


def test_trace_writes_the_spans_of_its_region(tmp_path):
    with profiler.span("before"):
        pass
    with profiler.trace(str(tmp_path)):
        with profiler.span("traced", request=5) as sp:
            with record_function("inside"):
                torch.ones(4).sum()
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        doc = json.load(f)
    mine = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
    assert [e["name"] for e in mine] == ["traced"]
    assert mine[0]["args"]["request"] == 5 and mine[0]["ph"] == "X"
    inside = next(e for e in doc["traceEvents"] if e.get("name") == "inside")
    assert mine[0]["ts"] <= inside["ts"] and inside["ts"] + inside["dur"] <= \
        mine[0]["ts"] + mine[0]["dur"]
    assert mine[0]["dur"] == pytest.approx(sp.seconds * 1e6)


def test_a_span_brackets_the_profiler_event_inside_it(tmp_path):
    """On the profiler's clock (an event's ts plus baseTimeNanoseconds) a
    span's time.time_ns() stamps hold the record_function event they
    enclose."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with profiler.span("bracket") as sp:
        with record_function("enclosed"):
            torch.ones(8).mul(2)
    prof.stop()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc["baseTimeNanoseconds"])
    assert base % 1_000_000_000 == 0  # a whole number of seconds
    ev = next(e for e in doc["traceEvents"] if e.get("name") == "enclosed")
    start = base + float(ev["ts"]) * 1e3
    assert sp.start_ns <= start and start + float(ev["dur"]) * 1e3 <= sp.end_ns


# ---------- portbench/spans.py on synthetic events ----------

BASE_S = 1790857026


def _sp(name, start_us, end_us, base_s=BASE_S):
    ns = base_s * 1_000_000_000
    return SimpleNamespace(name=name, start_ns=ns + int(start_us * 1e3),
                           end_ns=ns + int(end_us * 1e3))


def _train_case(**change):
    """Set-up (a run with the eager first step, then a run that replays),
    then a slice of 2 steps: each step's inputs launch a write (at 1005
    and 1035 us), the first replay's graph starts after a wait, the second
    was queued; the caller's read-back, then a caller's launch after a wait
    outside every span."""
    recorded = [
        _sp("train.first_step", 10, 90), _sp("train.run", 0, 100),
        _sp("train.replay", 210, 220), _sp("train.run", 200, 300),
        _sp("train.inputs", 1000, 1010), _sp("train.replay", 1010, 1030),
        _sp("train.inputs", 1030, 1040), _sp("train.replay", 1040, 1060),
        _sp("train.run", 1000, 1100),
    ] + change.get("extra", [])
    host = [("cudaLaunchKernel", 1005, 2), ("cudaGraphLaunch", 1012, 16),
            ("cudaLaunchKernel", 1035, 2), ("cudaGraphLaunch", 1042, 16),
            ("cudaMemcpyAsync", 1100, 300), ("cudaLaunchKernel", 1590, 5)]
    host += change.get("host", [])
    events = [("lr", 1006, 1), ("graph", 1030, 170), ("lr", 1200, 1), ("graph", 1210, 190),
              ("caller", 1600, 10)]
    ctx = SimpleNamespace(events=events, host=host, units=change.get("units", 2),
                          window_s=700e-6)
    totals = {"train.create_state": (1, 7.5), "train.first_step": (1, 2.25)}
    return recorded, ctx, totals


def _analyse(monkeypatch, recorded, ctx, path, totals=None):
    monkeypatch.setattr(profiler, "spans", lambda: list(recorded))
    monkeypatch.setattr(profiler, "totals", lambda: dict(totals or {}))
    return pspans.analyse(ctx, path)


def test_spans_recover_the_base_and_split_waits_by_span(monkeypatch):
    recorded, ctx, totals = _train_case()
    got = _analyse(monkeypatch, recorded, ctx, "train", totals)
    assert got["base_s"] == BASE_S and abs(got["remainder_s"]) < 1e-5
    # Waiting gaps: 1007-1030 (a graph launch began at 1012): 3 us in the
    # inputs, 20 in the replay; 1400-1600 (a launch at 1590): the caller's.
    # 1201-1210 is the device's own: its graph was launched at 1042.
    assert got["innermost"] == pytest.approx({"train.inputs": 3.0, "train.replay": 20.0})
    assert got["within"]["train.run"] == pytest.approx(23.0)
    assert got["caller"] == pytest.approx(200.0)
    assert got["device_side"] == pytest.approx(9.0)
    assert sum(got["innermost"].values()) + got["caller"] + got["device_side"] == \
        pytest.approx(232.0)
    monkeypatch.setattr(pspans, "_LAST", [None, None, None])
    assert pspans.within_ms_per_unit(ctx, "train", "train.run") == pytest.approx(0.0115)
    assert pspans.setup_s(ctx, "train.create_state") == 7.5
    assert pspans.setup_s(ctx, "train.first_step") == 2.25
    assert pspans.setup_s(ctx, "kernels.load") is None


def test_a_gap_goes_to_the_innermost_span_whatever_the_names():
    """The span that started last, or of two that started together the one
    that ends first, takes the gap, however the names sort."""
    nest = [("train.run", 0, 100), ("train.replay", 10, 90), ("z", 200, 300), ("a", 200, 250)]
    innermost, within, caller = pspans.attribute([(20, 10), (240, 20), (95, 10)], nest)
    assert innermost == pytest.approx({"train.replay": 10, "a": 10, "z": 10, "train.run": 5})
    assert within == pytest.approx({"train.run": 15, "train.replay": 10, "z": 20, "a": 10})
    assert caller == pytest.approx(5)


def test_base_recovery_takes_the_nearest_whole_second():
    base, rem = pspans.base_ns(BASE_S * 10**9 + 5_000_000_000_123, 5_000_000_000.0)
    assert base == BASE_S * 10**9 and rem == pytest.approx(1.23e-7, abs=1e-9)
    base, rem = pspans.base_ns(BASE_S * 10**9 + 999_990_000, 0.0)
    assert base == (BASE_S + 1) * 10**9 and rem == pytest.approx(-1e-5, abs=1e-9)


def test_waits_on_the_conversion_path_and_its_copies(monkeypatch):
    """One utterance: its copies in convert.h2d, convert.d2h and decode.h2d,
    and the caller's read of the waveform outside them."""
    recorded = [_sp("convert.h2d", 0, 10), _sp("convert.generator", 10, 50),
                _sp("convert.d2h", 50, 80), _sp("convert", 0, 80),
                _sp("decode.h2d", 85, 95), _sp("decode.vocoder", 95, 120), _sp("decode", 85, 120)]
    host = [("cudaMemcpyAsync", 2, 3), ("cudaLaunchKernel", 20, 2), ("cudaLaunchKernel", 40, 2),
            ("cudaMemcpyAsync", 55, 20), ("cudaMemcpyAsync", 86, 2), ("cudaMemcpyAsync", 90, 2),
            ("cudaLaunchKernel", 100, 2), ("cudaMemcpyAsync", 121, 30)]
    events = [("h2d", 4, 2), ("k", 21, 10), ("k", 41, 5), ("d2h", 60, 10), ("h2d", 87, 1),
              ("h2d", 91, 1), ("k", 101, 40), ("d2h", 145, 3)]
    ctx = SimpleNamespace(events=events, host=host, units=1, window_s=160e-6)
    got = _analyse(monkeypatch, recorded, ctx, "convert")
    assert got["base_s"] == BASE_S
    # Waiting gaps 6-21, 31-41, 46-60, 70-87, 88-91, 92-101; 141-145 is the
    # device's own (the vocoder's launch came at 100).
    assert got["within"]["convert"] == pytest.approx(15 + 10 + 14 + 10)
    assert got["within"]["decode"] == pytest.approx(2 + 3 + 9)
    assert got["caller"] == pytest.approx(5)  # 80-85, between the two
    assert got["device_side"] == pytest.approx(4)
    assert got["innermost"] == pytest.approx({
        "convert.h2d": 4, "convert.generator": 11 + 10 + 4, "convert.d2h": 10 + 10,
        "decode.h2d": 2 + 3 + 3, "decode.vocoder": 6})
    bad = host + [("cudaMemcpyAsync", 30, 2)]  # a copy inside the generator
    assert _analyse(monkeypatch, recorded, SimpleNamespace(**{**vars(ctx), "host": bad}),
                    "convert") is None


@pytest.mark.parametrize("case", ["units", "first_step_in_slice", "first_step_in_window",
                                  "not_whole_seconds", "launch_outside_replay", "no_spans"])
def test_each_void_case_reads_none(monkeypatch, capsys, case):
    change = {
        "units": {"units": 3},
        "first_step_in_slice": {"extra": [_sp("train.first_step", 1070, 1090)]},
        "first_step_in_window": {"extra": [_sp("train.first_step", 500, 600)]},
        "launch_outside_replay": {"host": [("cudaGraphLaunch", 1500, 4)]},
    }.get(case, {})
    recorded, ctx, totals = _train_case(**change)
    if case == "not_whole_seconds":
        recorded = [SimpleNamespace(name=sp.name, start_ns=sp.start_ns + 400_000_000,
                                    end_ns=sp.end_ns + 400_000_000) for sp in recorded]
    if case == "no_spans":
        monkeypatch.delattr(profiler, "spans")
        assert pspans.analyse(ctx, "train") is None
    else:
        assert _analyse(monkeypatch, recorded, ctx, "train", totals) is None
    assert "[portbench] spans:" in capsys.readouterr().err
