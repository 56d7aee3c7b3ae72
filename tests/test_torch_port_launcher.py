"""The port's pairwise launcher (``cli/launch_pairwise.py``) against the JAX
package's: the same pairs and shards for any speaker list and host count,
the same dry-run lines but for the train module's name, the forwarded
arguments, a failing job stopping the launch, and one real launch on the
CPU at a tiny width. The launch on the card is ``chip_smoke.py``'s
``pairwise`` phase.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from maskcyclegan_vc_tpu.cli import launch_pairwise as jax_launch
from maskcyclegan_vc_tpu_torch.cli import launch_pairwise as launch
from maskcyclegan_vc_tpu_torch.data.dataset import save_speaker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@settings(max_examples=60, deadline=None)
@given(n=st.integers(2, 12), hosts=st.integers(1, 8), seed=st.integers(0, 2 ** 31 - 1))
def test_pairs_and_shards_match_jax(n, hosts, seed):
    rs = np.random.RandomState(seed)
    ids = [f"VCC2{c}{i}" for c, i in zip(rs.choice(list("SMTF"), n), rs.permutation(100)[:n])]
    jobs = launch.pair_jobs(ids)
    assert jobs == jax_launch.pair_jobs(ids)
    for h in range(hosts):
        assert launch.shard_for_host(jobs, h, hosts) == jax_launch.shard_for_host(jobs, h, hosts)


def test_pair_count_12_speakers():
    ids = [f"S{i}" for i in range(12)]
    jobs = launch.pair_jobs(ids)
    assert len(jobs) == 66 and len(set(jobs)) == 66  # C(12, 2)


def test_host_shards_partition():
    jobs = launch.pair_jobs([f"S{i}" for i in range(12)])
    shards = [launch.shard_for_host(jobs, h, 4) for h in range(4)]
    assert sorted(j for s in shards for j in s) == sorted(jobs)
    sizes = [len(s) for s in shards]
    assert max(sizes) - min(sizes) <= 1


def _stdout(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.mark.parametrize("host, hosts", [(0, 1), (1, 2), (2, 4)])
def test_dry_run_prints_jax_commands_with_the_port_module(host, hosts):
    argv = ["--preprocessed_data_dir", "pre dir", "--speaker_ids", "VCC2TF1", "VCC2SF3",
            "VCC2SM3", "VCC2TM1", "--host_index", str(host), "--num_hosts", str(hosts),
            "--save_dir", "out", "--dry_run", "--", "--num_epochs", "3", "--device", "cpu"]
    got = _stdout(launch.main, argv)
    want = _stdout(jax_launch.main, argv)
    assert got == want.replace("maskcyclegan_vc_tpu.cli.train",
                               "maskcyclegan_vc_tpu_torch.cli.train")
    assert got != want and "maskcyclegan_vc_tpu.cli.train" not in got


def test_arguments_after_the_separator_are_forwarded(monkeypatch):
    calls = []
    monkeypatch.setattr(launch.subprocess, "run", lambda cmd, **kw: calls.append((cmd, kw)))
    launch.main(["--preprocessed_data_dir", "p", "--speaker_ids", "B", "A", "C",
                 "--", "--num_epochs", "2", "--batch_size", "1"])
    assert [c[0][c[0].index("--speaker_A_id") + 1:c[0].index("--speaker_A_id") + 4:2]
            for c in calls] == [["A", "B"], ["A", "C"], ["B", "C"]]
    for cmd, kw in calls:
        assert cmd[:3] == [sys.executable, "-m", "maskcyclegan_vc_tpu_torch.cli.train"]
        assert cmd[-4:] == ["--num_epochs", "2", "--batch_size", "1"]
        assert cmd[cmd.index("--save_dir") + 1] == "results"
        assert kw == {"check": True}


def test_a_failing_job_raises():
    """The real subprocess.run with check=True: the first job's non-zero
    exit stops the launch."""
    with pytest.raises(subprocess.CalledProcessError):
        launch.main(["--preprocessed_data_dir", "/nonexistent", "--speaker_ids", "A", "B",
                     "--", "--no_such_flag"])


def test_launch_on_the_cpu_trains_this_hosts_pairs_only(tmp_path):
    """Host 0 of 2 over 3 speakers at R = 8: its jobs (the 1st and 3rd
    pairs) leave checkpoints; host 1's pair has none."""
    rs = np.random.RandomState(0)
    speakers = ["VCC2SF3", "VCC2TF1", "VCC2SM3"]
    for sid in speakers:
        save_speaker(str(tmp_path / "pre"), sid,
                     [rs.randn(16, t).astype(np.float32) for t in (20, 33)],
                     np.zeros((16, 1), np.float32), np.ones((16, 1), np.float32))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "maskcyclegan_vc_tpu_torch.cli.launch_pairwise",
         "--preprocessed_data_dir", str(tmp_path / "pre"), "--speaker_ids", *speakers,
         "--host_index", "0", "--num_hosts", "2", "--save_dir", str(tmp_path / "results"),
         "--", "--device", "cpu", "--num_epochs", "1", "--batch_size", "1",
         "--num_frames", "16", "--n_mels", "16", "--residual_channels", "8",
         "--epochs_per_save", "1", "--epochs_per_plot", "100000", "--steps_per_print", "1",
         "--scan_epochs", "0"],
        env=env, capture_output=True, text=True, timeout=300, check=True).stdout
    assert out.startswith("host 0/2: 2 pair jobs\n")
    pairs = launch.pair_jobs(speakers)
    for i, (a, b) in enumerate(pairs):
        ckpt = tmp_path / "results" / f"mask_cyclegan_vc_{a}_{b}" / "ckpts" / "00001_state.npz"
        assert ckpt.exists() == (i % 2 == 0), (a, b)
