"""The port's profiling hooks (``obs/profiler.py``) on the CPU, against the
JAX package's: ``trace`` writes a Chrome trace holding the block's
operations (or says the profiler cannot start and runs the block);
``timed_steps`` chains the same steps to the same final state as JAX's,
synchronises on the same leaf, and divides by at least 1. The trace on
the card, naming the port's kernels, is in ``test_torch_port_cuda.py``.
"""

import glob
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maskcyclegan_vc_tpu.obs import profiler as jax_profiler
from maskcyclegan_vc_tpu_torch.obs import profiler


def test_trace_writes_a_json_trace_of_the_block(tmp_path):
    with profiler.trace(str(tmp_path)):
        torch.mm(torch.randn(16, 8), torch.randn(8, 4))
        torch.sigmoid(torch.ones(3))
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::mm", "aten::sigmoid"} <= names


def test_trace_that_cannot_start_says_so_and_runs_the_block(tmp_path, monkeypatch, capsys):
    def refuse(self):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler.profile, "start", refuse)
    ran = []
    with profiler.trace(str(tmp_path)):
        ran.append(True)
    assert ran == [True]
    assert "[profiler] trace unavailable: no profiler here" in capsys.readouterr().out
    assert not glob.glob(str(tmp_path / "*"))


def _steps(xp):
    """A toy chain in numpy-like ``xp``: state (w, count), metrics with keys
    out of sorted order."""
    def step(state, batch):
        w, n = state
        w = w * 0.5 + batch
        return (w, n + 1), {"z_last": w.sum() * 0.0 + 7.0, "a_first": w.sum(), "m": w}
    return step


@pytest.mark.parametrize("n", [1, 3, 8])
def test_timed_steps_matches_jax(n):
    rs = np.random.RandomState(n)
    batches = [rs.randn(4).astype(np.float32) for _ in range(n)]
    w0 = rs.randn(4).astype(np.float32)
    (jw, jn), jt = jax_profiler.timed_steps(_steps(jnp), (jnp.asarray(w0), 0),
                                            [jnp.asarray(b) for b in batches])
    (pw, pn), pt = profiler.timed_steps(_steps(torch), (torch.from_numpy(w0), 0),
                                        [torch.from_numpy(b) for b in batches])
    assert jn == pn == n
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-6, atol=0)
    assert pt > 0 and jt > 0


def test_default_leaf_is_the_smallest_key_as_in_jax():
    """jax.tree.leaves orders a dict by sorted key: both synchronise on
    "a_first", not on the first key inserted; a scalar that float() cannot
    read shows which leaf was taken."""
    seen = {}

    class Probe:
        def __init__(self, name):
            self.name = name

        def __float__(self):
            seen.setdefault("leaf", self.name)
            return 0.0

    def step(state, batch):
        return state, {"z": Probe("z"), "b": {"y": Probe("b/y")}, "a": [Probe("a/0")]}

    profiler.timed_steps(step, 0, [1])
    assert seen["leaf"] == "a/0"
    assert list(profiler.leaves({"z": 1, "b": {"y": 2, "x": 3}, "a": [4, (5, None)]})) \
        == [4, 5, 3, 2, 1]
    import jax
    assert jax.tree.leaves({"z": 1, "b": {"y": 2, "x": 3}, "a": [4, (5, None)]}) \
        == [4, 5, 3, 2, 1]


def test_an_empty_batch_list_divides_by_one(monkeypatch):
    """No step: the time over 1, in both; with no metrics to read, the
    caller names the leaf (JAX's default leaf of None fails too)."""
    with pytest.raises(ValueError, match="sync_leaf"):
        profiler.timed_steps(_steps(torch), "s", [])
    for mod in (profiler, jax_profiler):  # one time module: patched per call
        clock = iter([10.0, 12.5])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        assert mod.timed_steps(_steps(torch), "s", [], sync_leaf=lambda m: 0.0) == ("s", 2.5)
