"""The port's data parallelism (``parallel/``, ``--distributed``) on the CPU over gloo.

Processes are spawned with ``subprocess``, as ``tests/test_multiprocess.py``
spawns JAX's: the train and preprocess CLIs through torchrun
(``python -m torch.distributed.run``), and this file run as a script for the
step-level workers (``_worker``), each with torchrun's environment set by
hand. Sizes as ``tests/test_torch_port_train_step.py``'s: 16 mels x 32
frames, R = 8, a global batch of 2, one row a rank.

Tolerances, and why. Two ranks differ from one process only in the order of
the sums (a batch mean taken by one backward against two per-row backwards
averaged), so the first step's G losses hold at rtol 1e-5, the losses that
follow an update at 1e-3, Adam's moments at 2e-4 of the layer's largest
(``assert_adam_matches``) and the params at Adam's quantum: 2.02 lr after
one update and 4.2 lr after two. That quantum is the whole story in f32:
Adam's first update is lr * sign(g), and every conv bias that an
InstanceNorm follows has a true gradient of 0, so its computed gradient is
rounding, whose sign the order of the sums decides (measured: the two runs'
params 3.9 lr apart after two steps, where f64 puts the two gradients
within 6e-15). A wrong scale (a missing division by the world size) moves
the moments by 2x and fails at once. The bf16 wire is held as
``tests/test_sharding.py::test_shardmap_bf16_allreduce_bounded`` holds
JAX's: within 1e-3 of the f32 wire's params after two steps, finite.
"""

import os
import socket
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
sys.path.insert(0, _REPO)

from maskcyclegan_vc_tpu_torch.data.dataset import (  # noqa: E402
    compute_norm_stats,
    load_speaker,
    save_speaker,
)
from maskcyclegan_vc_tpu_torch.io.checkpoint import load_train_state  # noqa: E402
from maskcyclegan_vc_tpu_torch.io.jax_params import train_state_to_jax  # noqa: E402
from maskcyclegan_vc_tpu_torch.parallel import dist as port_dist  # noqa: E402
from maskcyclegan_vc_tpu_torch.parallel.mesh import (  # noqa: E402
    explicit_sync_fns,
    shard_batch,
    wire_bytes,
)
from maskcyclegan_vc_tpu_torch.parallel.stats import norm_stats_over_ranks  # noqa: E402
from maskcyclegan_vc_tpu_torch.train.schedules import ScheduleConfig  # noqa: E402
from maskcyclegan_vc_tpu_torch.train.state import TrainConfig, create_train_state  # noqa: E402
from maskcyclegan_vc_tpu_torch.train.step import make_train_step  # noqa: E402

SCHED = dict(num_epochs=10, n_samples=4, batch_size=2, decay_after=4, stop_identity_after=4)
N_MELS, FRAMES, R = 16, 32, 8
WORLD = 2
STEPS = 2
WIRES = ("float32", "bfloat16")
G_STEP_METRICS = ("g_loss", "g_adv_loss", "g_cycle_loss", "g_identity_loss", "identity_lambda")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in port_dist.ENV and k not in ("XLA_FLAGS", "MASKVC_REQUIRE_MULTIHOST")}
    env.update({"JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
                "PYTHONPATH": _REPO + os.pathsep + env.get("PYTHONPATH", "")}, **extra)
    return env


def _port_cfg():
    return TrainConfig(schedule=ScheduleConfig(**SCHED), n_mels=N_MELS, num_frames=FRAMES,
                       residual_channels=R)


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


# ---------- the step-level worker: this file run as a script ----------

def _worker(rank: int, world: int, port: int, work: str) -> None:
    """One rank: ``STEPS`` synced steps per wire from the start state on its
    rows of the saved global batches, then the collective statistics of the
    saved mels; everything it ends with into ``rank<r>.npz``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    created = port_dist.initialize("cpu")
    try:
        cfg = _port_cfg()
        with np.load(os.path.join(work, "inputs.npz")) as z:
            batches = [{k: z[f"batch{i}/{k}"] for k in ("real_A", "mask_A", "real_B", "mask_B")}
                       for i in range(STEPS)]
            mels = [z[k] for k in sorted(k for k in z.files if k.startswith("mel/"))]
        out = {}
        for wire in WIRES:
            state = load_train_state(os.path.join(work, "start.npz"),
                                     create_train_state(cfg, seed=7))
            grad_sync, metric_sync = explicit_sync_fns(wire)
            step = make_train_step(cfg, True, grad_sync=grad_sync, metric_sync=metric_sync)
            for i, b in enumerate(batches):
                state, metrics = step(state, shard_batch(_torch_batch(b)))
                for k, v in train_state_to_jax(state).items():
                    out[f"{wire}/{i}/state/{k}"] = v
                for k, v in metrics.items():
                    out[f"{wire}/{i}/metric/{k}"] = np.float64(v.item())
            out[f"{wire}/wire_bytes"] = np.int64(
                wire_bytes(state.g_params() + state.d_params(), wire))
        out["stats/mean"], out["stats/std"] = norm_stats_over_ranks(mels)
        np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    finally:
        port_dist.finalize(created)


def _start_workers(work: str, world: int):
    port = _free_port()
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                              str(port), work], env=_env(), cwd=_REPO,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]


def _collect(procs, work: str):
    logs = [p.communicate(timeout=300)[0].decode(errors="replace") for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(logs)
    out = []
    for r in range(len(procs)):
        with np.load(os.path.join(work, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _mels(seed=5, n=5):
    rs = np.random.RandomState(seed)
    return [rs.randn(N_MELS, t).astype(np.float32) * 2 + 1 for t in rs.randint(40, 90, size=n)]


# ---------- synced steps against JAX's data-parallel steps ----------

@pytest.fixture(scope="module")
def synced(tmp_path_factory, cli_procs):
    """The port's two ranks' results, and JAX's explicit-collective
    (shard_map) and GSPMD steps on a 2-device mesh of the conftest's 8 CPU
    devices, from one start, on the same explicit batches. The CLI runs
    (``cli_procs``) and the port's workers run while JAX compiles."""
    import jax

    from maskcyclegan_vc_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
    from maskcyclegan_vc_tpu.parallel.mesh import (
        make_mesh,
        make_shardmap_train_step,
        make_sharded_train_step,
        replicate,
    )
    from maskcyclegan_vc_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from maskcyclegan_vc_tpu.train.state import create_train_state as jax_create_train_state
    from test_torch_port_train_step import batch, jax_cfg, jax_flat

    work = str(tmp_path_factory.mktemp("synced"))
    cfg = jax_cfg()
    start = jax_create_train_state(cfg, seed=0)
    jax_save_checkpoint(os.path.join(work, "start.npz"), jax.device_get(start))
    batches = [batch(10 + i) for i in range(STEPS)]
    inputs = {f"batch{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()}
    mels = _mels()
    inputs.update({f"mel/{i:02d}": m for i, m in enumerate(mels)})
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    procs = _start_workers(work, WORLD)

    mesh = make_mesh(jax.devices()[:WORLD])
    makers = {"shard_map": lambda: make_shardmap_train_step(cfg, mesh, donate=False),
              "gspmd": lambda: make_sharded_train_step(cfg, mesh, donate=False)}
    jax_runs = {}
    for name, make in makers.items():
        step, js, run = make(), replicate(start, mesh), []
        for b in batches:
            js, jm = step(js, jax_shard_batch(b, mesh))
            run.append((jax_flat(js), {k: float(v) for k, v in jm.items()}))
        jax_runs[name] = run
    ranks = _collect(procs, work)
    with np.load(os.path.join(work, "start.npz")) as z:
        start_flat = {k: z[k] for k in z.files}
    return cfg, ranks, jax_runs, start_flat, mels


def _port_run(out, wire):
    """[(state flat, metrics)] per step of one wire, from a rank's file."""
    run = []
    for i in range(STEPS):
        pre = f"{wire}/{i}/"
        state = {k[len(pre) + 6:]: v for k, v in out.items() if k.startswith(pre + "state/")}
        metrics = {k[len(pre) + 7:]: float(v) for k, v in out.items()
                   if k.startswith(pre + "metric/")}
        run.append((state, metrics))
    return run


def test_ranks_end_in_the_same_state(synced):
    """Every rank applies the same synced update: the replicas stay equal,
    bit for bit, in both wires."""
    _, ranks, _, _, _ = synced
    assert ranks[0].keys() == ranks[1].keys()
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


@pytest.mark.parametrize("jax_step", ["shard_map", "gspmd"])
def test_synced_step_matches_jax(synced, jax_step):
    """The port's f32-wire step at world 2 against JAX's explicit-collective
    step and its GSPMD step on a 2-device mesh: metrics, Adam's moments and
    updates, params within Adam's quantum.

    JAX's shard_map step's gradients are ``WORLD`` times its GSPMD step's
    (measured: 2.0000 at world 2): under ``shard_map`` JAX already sums a
    replicated parameter's gradient over the axis, and ``grad_sync``'s psum
    then divides that sum by the world size, leaving the sum, not the mean.
    Adam's update hardly sees a scale (eps aside), which is why the JAX
    package's own tests, on params, pass. The port averages, as the GSPMD
    step and one process do: against shard_map its moments are scaled by
    the world size (mu) and its square (nu) before they are compared."""
    from test_torch_port_train_step import assert_adam_matches, step_lrs

    cfg, ranks, jax_runs, start, _ = synced
    scale = {".mu/": WORLD, ".nu/": WORLD ** 2} if jax_step == "shard_map" else {}
    port = _port_run(ranks[0], "float32")
    prev = (start, start)
    for i, ((pf, pm), (jf, jm)) in enumerate(zip(port, jax_runs[jax_step])):
        assert pm.keys() == jm.keys()
        for k in jm:
            rtol = 1e-5 if i == 0 and k in G_STEP_METRICS else 1e-3
            np.testing.assert_allclose(pm[k], jm[k], rtol=rtol, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        pf = {k: v * next((f for m, f in scale.items() if f"/0/{m}" in k), 1)
              for k, v in pf.items()}
        assert_adam_matches(jf, pf, *prev, step_lrs(cfg, i))
        prev = (jf, pf)
        assert pf.keys() == jf.keys() and int(pf[".step"]) == int(jf[".step"]) == i + 1
        for side, lr in (("g", cfg.schedule.generator_lr), ("d", cfg.schedule.discriminator_lr)):
            bound = (2.02 if i == 0 else 4.2) * lr
            for k in (k for k in jf if k.startswith(f".{side}_params/")):
                np.testing.assert_allclose(pf[k], jf[k], rtol=0, atol=bound,
                                           err_msg=f"step {i} {k}")


def test_bf16_wire_is_bounded(synced):
    """The bf16 wire: finite losses, params within 1e-3 of the f32 wire's
    after two steps (``test_sharding``'s bound for JAX's), and the wire
    really rounds: each synced gradient is a bf16 sum halved, so 4 x Adam's
    first moment after the first step, mu = g / 2, is a bf16 value
    everywhere (on the f32 wire it is not)."""
    _, ranks, _, _, _ = synced
    bf, f32 = _port_run(ranks[0], "bfloat16"), _port_run(ranks[0], "float32")
    for _, m in bf:
        assert all(np.isfinite(v) for v in m.values())
    want = f32[-1][0]
    for k in (k for k in want if "_params/" in k):
        np.testing.assert_allclose(bf[-1][0][k], want[k], rtol=0, atol=1e-3, err_msg=k)

    def bf16_share(flat):
        mu = np.concatenate([v.ravel() for k, v in flat.items() if "/.mu/" in k]) * 4
        t = torch.from_numpy(mu)
        return float((t.to(torch.bfloat16).float() == t).float().mean())
    assert bf16_share(bf[0][0]) == 1.0
    assert bf16_share(f32[0][0]) < 0.1
    assert int(ranks[0]["bfloat16/wire_bytes"]) * 2 == int(ranks[0]["float32/wire_bytes"])


def test_collective_stats_match_numpy_and_jax(synced):
    """Two ranks' collective statistics, the same on both, against numpy's
    ``compute_norm_stats`` over the concatenated frames and JAX's
    ``norm_stats_over_devices`` on the 8-device mesh."""
    from maskcyclegan_vc_tpu.parallel.stats import norm_stats_over_devices

    _, ranks, _, _, mels = synced
    mean, std = ranks[0]["stats/mean"], ranks[0]["stats/std"]
    np.testing.assert_array_equal(mean, ranks[1]["stats/mean"])
    np.testing.assert_array_equal(std, ranks[1]["stats/std"])
    assert mean.shape == std.shape == (N_MELS, 1) and mean.dtype == np.float32
    want_mean, want_std = compute_norm_stats(mels)
    np.testing.assert_allclose(mean, want_mean, atol=1e-5)
    np.testing.assert_allclose(std, want_std, atol=1e-5)
    jmean, jstd = norm_stats_over_devices(mels)
    np.testing.assert_allclose(mean, jmean, atol=1e-5)
    np.testing.assert_allclose(std, jstd, atol=1e-5)


def test_grad_sync_at_world_one_is_the_identity(tmp_path):
    """A process group of one (gloo, in this process): the synced step is
    the plain step, bit for bit: the all-reduce of one rank leaves the
    bucket as it is and the division is by 1."""
    import torch.distributed as dist

    from test_torch_port_train_step import batch

    cfg = _port_cfg()
    b = _torch_batch(batch(3))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        states = []
        for sync in (explicit_sync_fns("float32"), (None, None)):
            state = create_train_state(cfg, seed=1)
            state, m = make_train_step(cfg, True, grad_sync=sync[0],
                                       metric_sync=sync[1])(state, b)
            states.append((train_state_to_jax(state), {k: v.item() for k, v in m.items()}))
    finally:
        dist.destroy_process_group()
    (got, gm), (want, wm) = states
    assert gm == wm
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------- the CLIs through torchrun ----------

def _speakers(root):
    rs = np.random.RandomState(0)
    for sid in ("VCC2SF3", "VCC2TF1"):
        save_speaker(os.path.join(root, "pre"), sid,
                     [rs.randn(N_MELS, t).astype(np.float32) for t in (40, 52)],
                     rs.randn(N_MELS, 1).astype(np.float32),
                     (rs.rand(N_MELS, 1) + 0.5).astype(np.float32))


def _wavs(root):
    from maskcyclegan_vc_tpu_torch.data.audio_io import write_wav

    rs = np.random.RandomState(1)
    for sid, f0 in (("VCC2SF3", 220.0), ("VCC2TF1", 330.0)):
        os.makedirs(os.path.join(root, "wavs", sid), exist_ok=True)
        for i, n in enumerate((16640, 18630, 21000)):
            t = np.arange(n) / 22050
            x = (0.3 * np.sin(2 * np.pi * (f0 + 5 * i) * t) * (0.5 + 0.5 * np.sin(6 * np.pi * t))
                 + 0.25 * rs.randn(n) * (0.1 + np.abs(np.sin(2 * np.pi * 1.7 * t))))
            write_wav(os.path.join(root, "wavs", sid, f"{i}.wav"), x.astype(np.float32), 22050)


def _train_argv(root, name, *extra):
    return ["--name", name, "--save_dir", os.path.join(root, "results"),
            "--preprocessed_data_dir", os.path.join(root, "pre"), "--batch_size", "2",
            "--num_frames", str(FRAMES), "--n_mels", str(N_MELS), "--residual_channels", str(R),
            "--max_mask_len", "8", "--num_epochs", "2", "--epochs_per_save", "1",
            "--epochs_per_plot", "100", "--steps_per_print", "1", "--device", "cpu",
            "--seed", "3", *extra]


def _torchrun(module, argv):
    return [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(WORLD),
            "--master_addr", "127.0.0.1", "--master_port", str(_free_port()), "-m", module,
            "--distributed", *argv]


@pytest.fixture(scope="module")
def cli_procs():
    """Started together: the train CLI over 2 gloo ranks (--scan_epochs 1
    and 0) and in one process; the preprocess CLI over 2 ranks and in one
    process. 2 utterances of >= 32 frames a speaker at batch 2: one step an
    epoch, 2 epochs."""
    with tempfile.TemporaryDirectory() as root:
        _speakers(root)
        _wavs(root)
        train = "maskcyclegan_vc_tpu_torch.cli.train"
        pre = "maskcyclegan_vc_tpu_torch.cli.preprocess"
        pre_argv = ["--data_directory", os.path.join(root, "wavs"), "--speaker_ids",
                    "VCC2SF3", "VCC2TF1", "--device", "cpu"]
        cmds = {"two1": _torchrun(train, _train_argv(root, "two1")),
                "two0": _torchrun(train, _train_argv(root, "two0", "--scan_epochs", "0")),
                "one": [sys.executable, "-m", train, *_train_argv(root, "one")],
                "pre_two": _torchrun(pre, pre_argv + ["--preprocessed_data_directory",
                                                      os.path.join(root, "pre_two")]),
                "pre_one": [sys.executable, "-m", pre, *pre_argv,
                            "--preprocessed_data_directory", os.path.join(root, "pre_one")]}
        procs = {k: subprocess.Popen(c, env=_env(), cwd=_REPO, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT) for k, c in cmds.items()}
        yield root, procs


@pytest.fixture(scope="module")
def cli_runs(cli_procs):
    root, procs = cli_procs
    logs = {k: p.communicate(timeout=300)[0].decode(errors="replace") for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, f"{k}:\n{logs[k]}"
    out = {"logs": logs, "ckpt": {}, "log": {}, "pre": {}}
    for name in ("two1", "two0", "one"):
        run = os.path.join(root, "results", name)
        for e in (1, 2):
            with np.load(os.path.join(run, "ckpts", f"{e:05d}_state.npz")) as z:
                out["ckpt"][name, e] = {k: z[k] for k in z.files}
        with open(os.path.join(run, f"{name}.log")) as f:
            out["log"][name] = [line for line in f if line.startswith("[epoch")]
        out[name + "_files"] = sorted(os.listdir(os.path.join(run, "ckpts")))
    for name in ("pre_two", "pre_one"):
        for sid in ("VCC2SF3", "VCC2TF1"):
            out["pre"][name, sid] = load_speaker(os.path.join(root, name), sid)
    return out


def _logged(lines):
    return np.array([[float(v) for v in line.split("] ", 1)[1].split() if v[0].isdigit()]
                     for line in lines])


@pytest.mark.parametrize("mode", ["two1", "two0"])
def test_two_ranks_match_one_process(cli_runs, mode):
    """``torchrun --nproc_per_node 2 ... cli.train --distributed --device
    cpu`` against the same run in one process: the first step's losses at
    rtol 1e-5, the second's at 1e-3, both checkpoints within Adam's quantum
    of the one-process run's (2.02 lr after one update, 4.2 after two), the
    first one's moments at 2e-4 of their layer's largest; both modes."""
    from test_torch_port_train_step import assert_adam_matches

    two, one = _logged(cli_runs["log"][mode]), _logged(cli_runs["log"]["one"])
    assert two.shape == one.shape == (2, 7)
    np.testing.assert_allclose(two[0], one[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(two[1], one[1], rtol=1e-3)
    for e, quantum in ((1, 2.02), (2, 4.2)):
        got, want = cli_runs["ckpt"][mode, e], cli_runs["ckpt"]["one", e]
        assert got.keys() == want.keys() and int(got[".step"]) == int(want[".step"]) == e
        for side, lr in (("g", 2e-4), ("d", 1e-4)):
            for k in (k for k in want if k.startswith(f".{side}_params/")):
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=quantum * lr, err_msg=k)
        for k in (k for k in want if k.startswith("meta/")):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # The first update's moments and steps from the seeded start, which
    # both runs share, as the port's step is held against JAX's.
    cfg = TrainConfig(n_mels=N_MELS, num_frames=FRAMES, residual_channels=R)
    start = train_state_to_jax(create_train_state(cfg, seed=3))
    assert_adam_matches(cli_runs["ckpt"]["one", 1], cli_runs["ckpt"][mode, 1], start, start,
                        {"g": 2e-4, "d": 1e-4})


def test_two_rank_modes_agree_and_rank_zero_writes_alone(cli_runs):
    """Both modes over two ranks run the same sums: their checkpoints are
    equal bit for bit. One log line a step and one checkpoint an epoch:
    rank 1 wrote nothing beside rank 0."""
    for e in (1, 2):
        a, b = cli_runs["ckpt"]["two1", e], cli_runs["ckpt"]["two0", e]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for name in ("two1", "two0"):
        assert len(cli_runs["log"][name]) == 2
        assert cli_runs[name + "_files"] == ["00001_state.npz", "00002_state.npz"]
        log = cli_runs["logs"][name]
        assert log.count("[dist] data parallel over 2 processes, 1 of 2 rows each") == 2
        assert "bytes on a float32 wire" in log


def test_preprocess_two_ranks_match_one_process(cli_runs):
    """The preprocess CLI over two ranks: collective statistics, one set of
    files (rank 0's), equal to the one-process run's within the statistics'
    f32 sums (atol 1e-5)."""
    for sid in ("VCC2SF3", "VCC2TF1"):
        (mels, mean, std), (rmels, rmean, rstd) = (cli_runs["pre"][n, sid]
                                                   for n in ("pre_two", "pre_one"))
        np.testing.assert_allclose(mean, rmean, atol=1e-5)
        np.testing.assert_allclose(std, rstd, atol=1e-5)
        assert [m.shape for m in mels] == [m.shape for m in rmels]
        for m, r in zip(mels, rmels):
            np.testing.assert_allclose(m, r, atol=1e-4)


# ---------- the world and its failures ----------

_PROBE = """
from maskcyclegan_vc_tpu_torch.parallel import dist
created = dist.initialize("cpu")
print("INITIALIZED-OK", dist.world_size(), dist.rank(), created)
dist.finalize(created)
"""


def _probe(extra_env):
    p = subprocess.run([sys.executable, "-c", _PROBE], env=_env(**extra_env), cwd=_REPO,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=120)
    return p.returncode, p.stdout.decode(errors="replace")


def test_partial_environment_errors():
    """WORLD_SIZE and RANK without the rendezvous address must raise, not
    train alone on half the batch."""
    rc, log = _probe({"WORLD_SIZE": "2", "RANK": "0"})
    assert rc != 0 and "partial torchrun environment" in log, log
    assert "INITIALIZED-OK" not in log


def test_no_environment_is_a_quiet_single_process():
    rc, log = _probe({})
    assert rc == 0, log
    assert "single-process run" in log and "INITIALIZED-OK 1 0 False" in log


@pytest.mark.parametrize("world_env", [False, True])
def test_require_multihost_refuses_a_world_of_one(world_env):
    """``MASKVC_REQUIRE_MULTIHOST=1`` with no environment, or with a full
    one of WORLD_SIZE 1, raises."""
    env = {"MASKVC_REQUIRE_MULTIHOST": "1"}
    if world_env:
        env.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()))
    rc, log = _probe(env)
    assert rc != 0 and "multi-host run required" in log, log
    assert "INITIALIZED-OK" not in log


def _trainer_args(root, batch):
    from maskcyclegan_vc_tpu_torch.train.trainer import TrainerArgs

    return TrainerArgs(name="world", save_dir=os.path.join(root, "results"),
                       preprocessed_data_dir=os.path.join(root, "pre"), batch_size=batch,
                       num_frames=FRAMES, n_mels=N_MELS, residual_channels=R, num_epochs=1,
                       device="cpu")


def test_world_that_does_not_divide_the_batch_raises(tmp_path, monkeypatch):
    from maskcyclegan_vc_tpu_torch.train import trainer

    _speakers(str(tmp_path))
    monkeypatch.setattr(trainer, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="not divisible by 2 processes"):
        trainer.Trainer(_trainer_args(str(tmp_path), 3))


def test_batch_below_the_world_runs_replicated(tmp_path, monkeypatch, capsys):
    """Batch 1 on a world of 2: every process trains the whole batch with
    no collectives, and says so, as the JAX trainer falls back."""
    from maskcyclegan_vc_tpu_torch.train import trainer

    _speakers(str(tmp_path))
    monkeypatch.setattr(trainer, "world_size", lambda: 2)
    monkeypatch.setattr(trainer, "dist", types.SimpleNamespace(is_initialized=lambda: True))
    t = trainer.Trainer(_trainer_args(str(tmp_path), 1))
    assert t._sync == {} and t._rows == slice(None)
    assert "every process trains the whole batch" in capsys.readouterr().out


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
