"""The port's preprocess CLI (``--device cpu``: K8's plain version) against
the JAX package's, on the same synthetic wavs.

Two speakers of three wavs each, one shorter than 64 frames, which both
drop. The normalized mels and the statistics must agree at atol 1e-5 (f32
frontends in another summation order; the JAX package's frontend
tolerance), and each package's ``load_speaker`` must read the other's files.

The wavs are a tone plus amplitude-modulated broadband noise, so every mel
bin carries energy and varies over time (per-bin std >= 0.22 in log10
units). Two f32 frontends differ by about 1e-6 in log10 units, and
normalizing divides that by the bin's std: a bin near the 1e-5 floor or
with a near-constant level (a band-limited or resampled wav) would
amplify rounding past any fixed tolerance.
"""

import numpy as np
import pytest

from maskcyclegan_vc_tpu.cli.preprocess import main as jax_main
from maskcyclegan_vc_tpu.data.dataset import load_speaker as jax_load_speaker
from maskcyclegan_vc_tpu_torch.cli.preprocess import main
from maskcyclegan_vc_tpu_torch.data.audio_io import write_wav
from maskcyclegan_vc_tpu_torch.data.dataset import load_speaker

SPEAKERS = {"VCC2SF3": 220.0, "VCC2TF1": 330.0}
WAV_SAMPLES = (16640, 18630, 7000)  # 65, 73 frames kept; 28 dropped
KEPT = 2


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_preprocess")
    rs = np.random.RandomState(0)
    for sid, f0 in SPEAKERS.items():
        for i, n in enumerate(WAV_SAMPLES):
            t = np.arange(n) / 22050
            x = (0.3 * np.sin(2 * np.pi * (f0 + 5 * i) * t) * (0.5 + 0.5 * np.sin(6 * np.pi * t))
                 + 0.25 * rs.randn(n) * (0.1 + np.abs(np.sin(2 * np.pi * 1.7 * t))))
            (root / "wavs" / sid / "sub").mkdir(parents=True, exist_ok=True)
            write_wav(str(root / "wavs" / sid / "sub" / f"{i}.wav"), x.astype(np.float32), 22050)
    common = ["--data_directory", str(root / "wavs"), "--speaker_ids", *SPEAKERS]
    jax_main(common + ["--preprocessed_data_directory", str(root / "jax")])
    main(common + ["--preprocessed_data_directory", str(root / "port"), "--device", "cpu"])
    return root


@pytest.mark.parametrize("sid", list(SPEAKERS))
def test_outputs_match_jax(preprocessed, sid):
    got, mean, std = load_speaker(str(preprocessed / "port"), sid)
    want, jmean, jstd = jax_load_speaker(str(preprocessed / "jax"), sid)
    assert len(got) == len(want) == KEPT
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[0] == 80 and g.shape[1] >= 64
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    assert mean.shape == std.shape == (80, 1) and mean.dtype == std.dtype == np.float32
    np.testing.assert_allclose(mean, jmean, atol=1e-5, rtol=0)
    np.testing.assert_allclose(std, jstd, atol=1e-5, rtol=0)


@pytest.mark.parametrize("sid", list(SPEAKERS))
def test_files_cross_packages(preprocessed, sid):
    for writer in ("port", "jax"):
        a = load_speaker(str(preprocessed / writer), sid)
        b = jax_load_speaker(str(preprocessed / writer), sid)
        for x, y in zip(a[0], b[0]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    mels, mean, std = load_speaker(str(preprocessed / "port"), sid)
    cat = np.concatenate(mels, axis=1)  # normalized: zero mean, unit std per bin
    np.testing.assert_allclose(cat.mean(axis=1), 0.0, atol=1e-4)
    np.testing.assert_allclose(cat.std(axis=1), 1.0, atol=1e-4)


def test_cuda_without_a_gpu_raises(preprocessed, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--data_directory", str(preprocessed / "wavs"), "--speaker_ids", "VCC2SF3",
              "--preprocessed_data_directory", str(preprocessed / "nogpu")])
    assert not (preprocessed / "nogpu").exists()
