"""The port's reference-checkpoint and data tails against the JAX package.

- ``io.checkpoint.import_reference_checkpoints``: six reference-format
  ``.pth.tar`` files, written from seeded port modules (which carry the
  reference's ``state_dict`` names), loaded by both packages: every
  parameter equal, leaf for leaf.
- ``data/synth.py``: the same corpus bit for bit for a seed.
- ``data/native.py``: the port's binding of ``native/wavio.cpp`` (built
  under ``build/``) against the numpy reader, scipy's resampler and the JAX
  package's binding.
- The frontend pinned to ``tests/fixtures/melfb_golden.npz``, as
  ``tests/test_data.py`` pins JAX's: the filterbank bit for bit, the
  log-mels of both DFT paths within 2e-4 of the float64 golden values.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from maskcyclegan_vc_tpu.data import synth as jax_synth
from maskcyclegan_vc_tpu.io.checkpoint import _flatten as jax_flatten
from maskcyclegan_vc_tpu.io.checkpoint import (
    import_reference_checkpoints as jax_import_reference_checkpoints,
)
from maskcyclegan_vc_tpu.train.schedules import ScheduleConfig as JaxScheduleConfig
from maskcyclegan_vc_tpu.train.state import TrainConfig as JaxTrainConfig
from maskcyclegan_vc_tpu.train.state import create_train_state as jax_create_train_state
from maskcyclegan_vc_tpu_torch.data import audio_io, native, synth
from maskcyclegan_vc_tpu_torch.data.melspec import log_mel_spectrogram, mel_filterbank
from maskcyclegan_vc_tpu_torch.io.checkpoint import (
    REFERENCE_NAMES,
    import_reference_checkpoints,
)
from maskcyclegan_vc_tpu_torch.io.jax_params import train_state_to_jax
from maskcyclegan_vc_tpu_torch.ops.melspec import log_mel_spectrogram_fused
from maskcyclegan_vc_tpu_torch.train.state import TrainConfig, create_train_state

torch.set_num_threads(1)
N_MELS, R = 16, 8
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "melfb_golden.npz")


# ---------- reference checkpoints ----------

@pytest.fixture(scope="module")
def reference_dir(tmp_path_factory):
    """Six ``{epoch:05d}_<model>.pth.tar`` files in the reference's layout,
    from port modules seeded apart from any state either test creates."""
    root = tmp_path_factory.mktemp("reference_ckpts")
    src = create_train_state(TrainConfig(n_mels=N_MELS, residual_channels=R), seed=11)
    for models in (src.g, src.d):
        for name, model in models.items():
            torch.save({"ckpt_info": {"epoch": 500}, "model_state": model.state_dict()},
                       root / f"00500_{REFERENCE_NAMES[name]}.pth.tar")
    return root, train_state_to_jax(src)


def test_import_reference_checkpoints_matches_jax(reference_dir):
    root, src = reference_dir
    state = create_train_state(TrainConfig(n_mels=N_MELS, residual_channels=R), seed=0)
    before = train_state_to_jax(state)
    got_state, epoch = import_reference_checkpoints(str(root), 500, state)
    assert got_state is state and epoch == 500
    got = train_state_to_jax(state)

    jcfg = JaxTrainConfig(schedule=JaxScheduleConfig(), n_mels=N_MELS, residual_channels=R)
    jstate, jepoch = jax_import_reference_checkpoints(str(root), 500,
                                                      jax_create_train_state(jcfg, seed=0))
    want = jax_flatten(jax.device_get(jstate))
    assert jepoch == 500
    params = [k for k in want if k.startswith((".g_params/", ".d_params/"))]
    assert len(params) > 100 and set(params) == {k for k in got if "_params/" in k}
    for k in params:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], src[k], err_msg=k)
    # The dead downSample4 block is loaded too; the optimizers are untouched.
    assert sum("downSample4" in k for k in params) == 16
    for k in before:
        if not k.startswith((".g_params/", ".d_params/")):
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)


def test_import_reference_checkpoints_needs_all_six(reference_dir, tmp_path):
    root, _ = reference_dir
    for name in list(REFERENCE_NAMES.values())[:5]:
        (tmp_path / f"00500_{name}.pth.tar").write_bytes(
            (root / f"00500_{name}.pth.tar").read_bytes())
    state = create_train_state(TrainConfig(n_mels=N_MELS, residual_channels=R), seed=0)
    with pytest.raises(FileNotFoundError):
        import_reference_checkpoints(str(tmp_path), 500, state)


# ---------- data/synth ----------

@pytest.mark.parametrize("parallel", [False, True])
def test_synth_corpus_matches_jax(tmp_path, parallel):
    kw = dict(n_utts=3, seed=4, parallel=parallel, duration_s=0.4)
    got = synth.make_corpus(str(tmp_path / "port"), **kw)
    want = jax_synth.make_corpus(str(tmp_path / "jax"), **kw)
    assert sorted(got) == sorted(want) == ["VCC2SF3", "VCC2TF1"]
    for sid in want:
        for a, b in zip(got[sid], want[sid]):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), (a, b)


def test_synth_utterance_and_content_match_jax():
    assert {k: dataclasses.astuple(v) for k, v in synth.DEFAULT_SPEAKERS.items()} == \
        {k: dataclasses.astuple(v) for k, v in jax_synth.DEFAULT_SPEAKERS.items()}
    c = synth.make_content(np.random.RandomState(9), 0.5)
    assert dataclasses.astuple(c) == dataclasses.astuple(
        jax_synth.make_content(np.random.RandomState(9), 0.5))
    got = synth.synth_utterance(synth.DEFAULT_SPEAKERS["VCC2SM3"], c, noise_seed=3)
    want = jax_synth.synth_utterance(jax_synth.DEFAULT_SPEAKERS["VCC2SM3"],
                                     jax_synth.make_content(np.random.RandomState(9), 0.5),
                                     noise_seed=3)
    assert got.dtype == np.float32 and np.abs(got).max() <= 0.6 + 1e-6
    np.testing.assert_array_equal(got, want)


# ---------- data/native ----------

@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip("g++ unavailable: the native binding cannot build")
    return native.library_path()


def test_native_builds_under_build_not_native(built):
    assert built.exists() and built.parent.name == "native" and built.parent.parent.name == "build"
    assert native.SOURCE.exists()


def test_native_decode_matches_numpy_and_jax(built, tmp_path):
    from maskcyclegan_vc_tpu.data import native as jax_native

    rs = np.random.RandomState(0)
    x = np.clip(rs.randn(22050) * 0.3, -1, 1).astype(np.float32)
    path = str(tmp_path / "a.wav")
    audio_io.write_wav(path, x, 22050)
    got, sr = native.read_wav(path)
    want, want_sr = audio_io.read_wav(path)
    assert sr == want_sr == 22050
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_native.read_wav(path)[0])


def test_native_resample_matches_scipy_and_jax(built, tmp_path):
    from maskcyclegan_vc_tpu.data import native as jax_native

    rs = np.random.RandomState(1)
    t = np.arange(16000) / 16000.0
    x = (np.sin(2 * np.pi * 440 * t) * 0.5 + 0.05 * rs.randn(t.size)).astype(np.float32)
    got = native.resample(x, 16000, 22050)
    np.testing.assert_array_equal(got, jax_native.resample(x, 16000, 22050))
    want = audio_io.resample(x, 16000, 22050)
    assert abs(got.size - want.size) <= 2
    n = min(got.size, want.size)
    # The same polyphase filter family as scipy's; the interiors agree.
    assert np.abs(got[100:n - 100] - want[100:n - 100]).max() < 5e-3
    path = str(tmp_path / "b.wav")
    audio_io.write_wav(path, x, 16000)
    np.testing.assert_array_equal(native.load_audio(path, 22050),
                                  native.resample(native.read_wav(path)[0], 16000, 22050))
    np.testing.assert_array_equal(native.load_audio(path, 22050),
                                  jax_native.load_audio(path, 22050))


# ---------- the frontend's golden fixture ----------

def test_mel_filterbank_matches_golden_fixture():
    with np.load(FIXTURE) as z:
        np.testing.assert_array_equal(mel_filterbank(), z["melfb"])


@pytest.mark.parametrize("path", ["matmul", "rfft", "fused"])
def test_log_mel_matches_golden_fixture(path):
    """Both plain DFT paths and the K8 wrapper (its plain version on the
    CPU) against the float64 np.fft golden log-mels of a fixed signal."""
    with np.load(FIXTURE) as z:
        audio, want = torch.from_numpy(z["audio"])[None], z["logmel"]
    if path == "fused":
        got = log_mel_spectrogram_fused(audio)[0].numpy()
    else:
        got = log_mel_spectrogram(audio, use_fft=path == "rfft")[0].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4)
