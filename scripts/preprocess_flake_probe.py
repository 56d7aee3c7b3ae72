#!/usr/bin/env python3
"""Where `chip_smoke.py`'s preprocess check moves: many fresh processes on one card.

`chip_smoke.py`'s preprocess phase runs the preprocess CLI on the card and
on the CPU over 2 speakers x 5 synthetic wavs and holds the two sides'
log-mels (each de-normalized with its own speaker statistics) within 5e-5
log10 units. This script runs that phase's inputs (the same wavs, made from
``np.random.RandomState(2)`` by the same function) in ``--runs`` fresh
processes, one after another, and in each compares against an f64 numpy
log-mel of the same padded audio, built from the port's own
``data/melspec.py`` constants (window, DFT bases and filterbank, f32 values
computed with in f64):

- the card CLI's raw log-mels (``cli/preprocess.py --device cuda``);
- the CPU CLI's raw log-mels (``--device cpu``, the plain version);
- K8 called directly (``ops.melspec.log_mel_spectrogram_fused``), three
  times per utterance;
- the plain version on the CPU at 1, 2 and 4 threads beside the default;
- the check itself, as `chip_smoke.py` computes it from the files.

It prints the worst error per utterance and per side over the runs, each
run's check and whether its K8 output (and its CPU output) is bit-identical
to the first run's. Every ``--rebuild_every``-th process (the first among
them) deletes ``build/kernels`` and builds all five kernel sources in
process first, as a `chip_smoke.py` run in a fresh checkout does.

    python3 scripts/preprocess_flake_probe.py [--runs 30] [--rebuild_every 10]

``--first_call N`` asks a narrower question: the plain (CPU) frontend's
first call in a fresh process, on the first utterance. It runs N fresh
processes for each variant (four at a time): ``cuda`` (the card initialised
and one K8 launch first, as in the CLI run), ``cpu`` (no card at all),
``threads1`` (the card first, then ``torch.set_num_threads(1)``), and
keeps each process's intermediates (framed audio, the two DFT products, the
magnitudes, the mels, the log-mels). It prints, per variant, how many
processes' bits left the most common result and, for each that did, the
first intermediate that moved, its count of moved elements, their frames
and bins, and the relative size of the move.

Working files go to ``build/preprocess_flake_probe/``; about 10 s a run on
an H100 host (35 s for a run that builds).
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
WORK = os.path.join(ROOT, "build", "preprocess_flake_probe")
SPEAKERS = {"VCC2SF3": 220.0, "VCC2TF1": 330.0}      # chip_smoke.py's
UTTERANCE_FRAMES = (173, 260, 345, 431, 517)
HOP, SAMPLE_RATE = 256, 22050
MEL_TOL = 5e-5
THREADS = (1, 2, 4)
SOURCES = ["in_gate", "ps_in_swish", "melspec", "melgan_stack", "pixel_shuffle"]


def synthetic_wav(frames: int, f0: float, rs) -> np.ndarray:
    """chip_smoke.synthetic_wav, verbatim."""
    t = np.arange(frames * HOP) / SAMPLE_RATE
    x = (0.3 * np.sin(2 * np.pi * f0 * t) * (0.5 + 0.5 * np.sin(6 * np.pi * t))
         + 0.25 * rs.randn(t.size) * (0.1 + np.abs(np.sin(2 * np.pi * 1.7 * t))))
    return x.astype(np.float32)


def utterances():
    """(speaker, index) in the CLI's order."""
    return [(sid, i) for sid in SPEAKERS for i in range(len(UTTERANCE_FRAMES))]


def write_wavs(wavs: str) -> None:
    from maskcyclegan_vc_tpu_torch.data.audio_io import write_wav

    rs = np.random.RandomState(2)
    for sid, f0 in SPEAKERS.items():
        os.makedirs(os.path.join(wavs, sid), exist_ok=True)
        for i, t in enumerate(UTTERANCE_FRAMES):
            write_wav(os.path.join(wavs, sid, f"{i:03d}.wav"),
                      synthetic_wav(t, f0 + 7 * i, rs), SAMPLE_RATE)


def padded(audio: np.ndarray) -> np.ndarray:
    """The audio as ``cli/preprocess.make_mel_fn`` hands it to K8."""
    from maskcyclegan_vc_tpu_torch.cli.preprocess import BUCKET_FRAMES
    from maskcyclegan_vc_tpu_torch.data.melspec import HOP_LENGTH, N_FFT, PAD, num_frames

    t = num_frames(audio.shape[0])
    tb = -(-t // BUCKET_FRAMES) * BUCKET_FRAMES
    need = (tb - 1) * HOP_LENGTH + N_FFT
    a = np.pad(audio, (PAD, PAD), mode="reflect")
    return np.ascontiguousarray(np.pad(a, (0, max(0, need - a.shape[0])))[:need], np.float32)


def f64_log_mel(audio: np.ndarray) -> np.ndarray:
    """(80, t) log10-mel of the padded audio in float64 from the port's
    f32 constants."""
    from maskcyclegan_vc_tpu_torch.data.melspec import (
        HOP_LENGTH, MEL_FLOOR, N_FFT, _dft_bases, hann_window_periodic, mel_filterbank,
        num_frames)

    t = num_frames(audio.shape[0])
    a = padded(audio).astype(np.float64)
    idx = np.arange(t)[:, None] * HOP_LENGTH + np.arange(N_FFT)[None, :]
    frames = a[idx] * hann_window_periodic().astype(np.float64)
    cos_b, sin_b = (b.astype(np.float64) for b in _dft_bases(N_FFT))
    mag = np.sqrt((frames @ cos_b) ** 2 + (frames @ sin_b) ** 2 + 1e-24)
    mel = mel_filterbank().astype(np.float64) @ mag.T
    return np.log10(np.maximum(mel, MEL_FLOOR))


def child(run: int, rebuild: bool) -> None:
    import torch

    from maskcyclegan_vc_tpu_torch.cli import preprocess as cli
    from maskcyclegan_vc_tpu_torch.data.audio_io import load_audio
    from maskcyclegan_vc_tpu_torch.data.dataset import load_speaker
    from maskcyclegan_vc_tpu_torch.data.melspec import num_frames
    from maskcyclegan_vc_tpu_torch.ops import cuda_lib, melspec

    if rebuild:
        shutil.rmtree(cuda_lib.BUILD_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        cuda_lib.build(SOURCES)
        print(f"run {run}: built {SOURCES} in {time.perf_counter() - t0:.1f} s", flush=True)
    wavs = os.path.join(WORK, "wavs")
    raw = {"cuda": [], "cpu": []}
    real = cli.make_mel_fn

    def recording(device):
        fn = real(device)

        def mel_fn(audio):
            m = fn(audio)
            raw[torch.device(device).type].append(m)
            return m
        return mel_fn

    cli.make_mel_fn = recording
    out = {}
    try:
        for dev in ("cuda", "cpu"):
            d = os.path.join(WORK, f"run{run}", dev)
            cli.main(["--data_directory", wavs, "--speaker_ids", *SPEAKERS,
                      "--preprocessed_data_directory", d, "--device", dev])
    finally:
        cli.make_mel_fn = real
    check = 0.0
    for sid in SPEAKERS:
        mels, mean, std = load_speaker(os.path.join(WORK, f"run{run}", "cuda"), sid)
        ref, rmean, rstd = load_speaker(os.path.join(WORK, f"run{run}", "cpu"), sid)
        for m, r in zip(mels, ref):
            check = max(check, float(np.abs((m * std + mean) - (r * rstd + rmean)).max()))
    out["check"] = np.float64(check)
    out["card_cli"] = np.stack([np.pad(m, ((0, 0), (0, 600 - m.shape[1]))) for m in raw["cuda"]])
    out["cpu_cli"] = np.stack([np.pad(m, ((0, 0), (0, 600 - m.shape[1]))) for m in raw["cpu"]])
    k8, plain = [], {n: [] for n in (*THREADS, 0)}
    default_threads = torch.get_num_threads()
    for sid, i in utterances():
        audio = load_audio(os.path.join(wavs, sid, f"{i:03d}.wav"), target_sr=SAMPLE_RATE)
        t = num_frames(audio.shape[0])
        x = torch.from_numpy(padded(audio))[None]
        reps = [melspec.log_mel_spectrogram_fused(x.cuda(), pad=False)[0, :, :t].cpu().numpy()
                for _ in range(3)]
        k8.append(np.stack([np.pad(r, ((0, 0), (0, 600 - t))) for r in reps]))
        for n in (*THREADS, 0):
            torch.set_num_threads(n or default_threads)
            with torch.inference_mode():
                m = melspec.log_mel_spectrogram_plain(x, pad=False)[0, :, :t].numpy()
            plain[n].append(np.pad(m, ((0, 0), (0, 600 - t))))
        torch.set_num_threads(default_threads)
    out["k8"] = np.stack(k8)
    for n, v in plain.items():
        out[f"plain{n}"] = np.stack(v)
    out["threads"] = np.int64(default_threads)
    np.savez(os.path.join(WORK, f"run{run}.npz"), **out)


FIRST_VARIANTS = ("cuda", "cpu", "threads1")
STAGES = ("frames", "re", "im", "mag", "mel", "log")


def first_child(variant: str, run: int) -> None:
    """The plain frontend's first call in this process, stage by stage."""
    import torch

    with np.load(os.path.join(WORK, "first_input.npz")) as z:
        a = z["audio"]
    if variant in ("cuda", "threads1"):
        from maskcyclegan_vc_tpu_torch.ops import melspec

        melspec.log_mel_spectrogram_fused(torch.from_numpy(a)[None].cuda(), pad=False)
        torch.cuda.synchronize()
    if variant == "threads1":
        torch.set_num_threads(1)
    from maskcyclegan_vc_tpu_torch.data.melspec import (
        MEL_FLOOR, _frontend_constants, frame_signal)

    with torch.inference_mode():
        win, cos_b, sin_b, fb = _frontend_constants("cpu")
        frames = frame_signal(torch.from_numpy(a)[None]) * win
        re = frames @ cos_b
        im = frames @ sin_b
        mag = torch.sqrt(re * re + im * im + 1e-24)
        mel = (mag @ fb.T).transpose(-1, -2)
        log = torch.log10(torch.clamp(mel, min=MEL_FLOOR))
    out = dict(zip(STAGES, (t[0].numpy() for t in (frames, re, im, mag, mel, log))))
    np.savez(os.path.join(WORK, f"first_{variant}_{run}.npz"), threads=torch.get_num_threads(),
             **out)


def first_call(n: int) -> int:
    import hashlib

    from maskcyclegan_vc_tpu_torch.data.audio_io import load_audio

    from maskcyclegan_vc_tpu_torch.ops import cuda_lib

    shutil.rmtree(WORK, ignore_errors=True)
    write_wavs(os.path.join(WORK, "wavs"))
    cuda_lib.build(["melspec"])
    sid, i = utterances()[0]
    audio = load_audio(os.path.join(WORK, "wavs", sid, f"{i:03d}.wav"), target_sr=SAMPLE_RATE)
    np.savez(os.path.join(WORK, "first_input.npz"), audio=padded(audio))
    want = f64_log_mel(audio)
    t = want.shape[1]
    for variant in FIRST_VARIANTS:
        t0 = time.perf_counter()
        jobs = [(variant, r) for r in range(n)]
        while jobs:
            batch, jobs = jobs[:4], jobs[4:]
            procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--first_child",
                                       v, str(r)], cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT) for v, r in batch]
            for pr in procs:
                log = pr.communicate()[0]
                if pr.returncode:
                    print(log.decode(errors="replace")[-3000:])
                    raise RuntimeError("a first-call process failed")
        runs = []
        for r in range(n):
            with np.load(os.path.join(WORK, f"first_{variant}_{r}.npz")) as z:
                runs.append({k: z[k] for k in z.files})
        digests = [hashlib.sha256(e["log"].tobytes()).hexdigest() for e in runs]
        mode = max(set(digests), key=digests.count)
        ref = runs[digests.index(mode)]
        moved = [r for r, d in enumerate(digests) if d != mode]
        errs = [float(np.abs(e["log"][:, :t] - want).max()) for e in runs]
        print(f"first call, {variant}: {n} processes ({int(runs[0]['threads'])} threads), "
              f"{len(moved)} left the most common bits; error against f64 "
              f"{min(errs):.3g}-{max(errs):.3g} (most common {errs[digests.index(mode)]:.3g}); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for r in moved:
            e = runs[r]
            first = next(k for k in STAGES if not np.array_equal(e[k], ref[k]))
            diff = e[first] != ref[first]
            idx = np.argwhere(diff)
            rel = np.abs(e[first] - ref[first])[diff] / np.maximum(np.abs(ref[first][diff]), 1e-30)
            print(f"  process {r}: first moved at {first} {ref[first].shape}: {int(diff.sum())} "
                  f"elements, rows {idx[:, 0].min()}-{idx[:, 0].max()} "
                  f"({len(np.unique(idx[:, 0]))} distinct), columns {idx[:, 1].min()}-"
                  f"{idx[:, 1].max()} ({len(np.unique(idx[:, 1]))} distinct); relative move "
                  f"median {np.median(rel):.3g}, max {rel.max():.3g}; log error against f64 "
                  f"{errs[r]:.3g}", flush=True)
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--runs", type=int, default=30)
    p.add_argument("--rebuild_every", type=int, default=10,
                   help="every n-th process builds the kernels in process (0: none)")
    p.add_argument("--first_call", type=int, default=0,
                   help="fresh processes per variant for the first-call question")
    p.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--rebuild", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--first_child", nargs=2, default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child is not None:
        child(args.child, args.rebuild)
        return 0
    if args.first_child is not None:
        first_child(args.first_child[0], int(args.first_child[1]))
        return 0
    if args.first_call:
        return first_call(args.first_call)

    import torch

    if not torch.cuda.is_available():
        print("preprocess_flake_probe: no CUDA device", file=sys.stderr)
        return 1
    from maskcyclegan_vc_tpu_torch.data.audio_io import load_audio
    from maskcyclegan_vc_tpu_torch.data.melspec import num_frames
    from maskcyclegan_vc_tpu_torch.ops import cuda_lib

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}; torch {torch.__version__}", flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    write_wavs(os.path.join(WORK, "wavs"))
    cuda_lib.build(SOURCES)
    wavs = os.path.join(WORK, "wavs")
    want, lens = [], []
    for sid, i in utterances():
        audio = load_audio(os.path.join(wavs, sid, f"{i:03d}.wav"), target_sr=SAMPLE_RATE)
        want.append(f64_log_mel(audio))
        lens.append(num_frames(audio.shape[0]))

    runs = []
    for r in range(args.runs):
        rebuild = args.rebuild_every > 0 and r % args.rebuild_every == 0
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", str(r),
                               *(["--rebuild"] if rebuild else [])],
                              cwd=ROOT, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            raise RuntimeError(f"run {r} failed")
        with np.load(os.path.join(WORK, f"run{r}.npz")) as z:
            runs.append({k: z[k] for k in z.files})
        e = runs[-1]

        def worst(key, rep=None):
            return max(float(np.abs((e[key][u] if rep is None else e[key][u, rep])[:, :t]
                                    - want[u]).max()) for u, t in enumerate(lens))
        same_k8 = np.array_equal(e["k8"], runs[0]["k8"])
        same_rep = all(np.array_equal(e["k8"][:, 0], e["k8"][:, j]) for j in (1, 2))
        same_cpu = np.array_equal(e["cpu_cli"], runs[0]["cpu_cli"])
        same_card = np.array_equal(e["card_cli"], runs[0]["card_cli"])
        print(f"run {r}{' (built in process)' if rebuild else ''}: check {float(e['check']):.3g} "
              f"({'FAIL' if e['check'] > MEL_TOL else 'pass'}); against f64: card CLI "
              f"{worst('card_cli'):.3g}, CPU CLI {worst('cpu_cli'):.3g}, K8 {worst('k8', 0):.3g}; "
              f"K8 bits = run 0's {same_k8}, its 3 repeats equal {same_rep}; card CLI bits = run "
              f"0's {same_card}; CPU CLI bits = run 0's {same_cpu}; {int(e['threads'])} threads; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    sides = {"card CLI": ("card_cli", None), "CPU CLI": ("cpu_cli", None), "K8": ("k8", 0),
             **{f"plain {n or 'default'} thr": (f"plain{n}", None) for n in (*THREADS, 0)}}
    print("worst |error| against the f64 log-mel over the runs, log10 units, min-max over runs:")
    for u, ((sid, i), t) in enumerate(zip(utterances(), lens)):
        cells = []
        for name, (key, rep) in sides.items():
            errs = [float(np.abs((e[key][u] if rep is None else e[key][u, rep])[:, :t]
                                 - want[u]).max()) for e in runs]
            cells.append(f"{name} {min(errs):.3g}-{max(errs):.3g}")
        print(f"  {sid} {i} ({t} frames): " + "; ".join(cells))
    fails = sum(float(e["check"]) > MEL_TOL for e in runs)
    k8_moves = sum(not np.array_equal(e["k8"], runs[0]["k8"]) for e in runs)
    cpu_moves = sum(not np.array_equal(e["cpu_cli"], runs[0]["cpu_cli"]) for e in runs)
    card_moves = sum(not np.array_equal(e["card_cli"], runs[0]["card_cli"]) for e in runs)
    thread_moves = sum(not np.array_equal(e[f"plain{n}"], e["plain0"])
                       for e in runs for n in THREADS)
    print(f"summary: {len(runs)} runs, {fails} failed the 5e-05 check; card CLI moved from run "
          f"0's bits in {card_moves}, K8 in {k8_moves}, CPU CLI in {cpu_moves}; the plain "
          f"version at 1/2/4 threads differs from the default's in {thread_moves} of "
          f"{len(runs) * len(THREADS)}; check {min(float(e['check']) for e in runs):.3g}-"
          f"{max(float(e['check']) for e in runs):.3g}", flush=True)
    print(smi.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
