"""The port's conversion slice on the CPU against the JAX package's CLI.

Speakers and a checkpoint are written by the JAX package; its
``cli.test.main`` and the port's ``main(..., "--device", "cpu")`` convert
the same utterances into two directories, and the mels must agree to
atol 1e-4 (f32 through ~20 chained norm layers at a small width).
"""

import ast
import dataclasses
import glob
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskcyclegan_vc_tpu.cli.test import main as jax_main
from maskcyclegan_vc_tpu.data.dataset import load_speaker as jax_load_speaker
from maskcyclegan_vc_tpu.data.dataset import save_speaker as jax_save_speaker
from maskcyclegan_vc_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from maskcyclegan_vc_tpu.models import Generator as JaxGenerator
from maskcyclegan_vc_tpu.utils.init import fast_init
from maskcyclegan_vc_tpu_torch.cli.test import load_generator_params, main
from maskcyclegan_vc_tpu_torch.data.dataset import load_speaker, save_speaker
from maskcyclegan_vc_tpu_torch.io.checkpoint import (
    load_checkpoint_subtree,
    save_checkpoint,
)
from maskcyclegan_vc_tpu_torch.io.jax_params import (
    generator_params_from_jax,
    generator_params_to_jax,
)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
N_MELS, R = 16, 8
LENGTHS = (37, 70, 100)  # none a multiple of 64: buckets 64, 128, 128


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_convert")
    rs = np.random.RandomState(0)
    for sid in ("VCC2SF3", "VCC2TF1"):
        mels = [rs.randn(N_MELS, t).astype(np.float32) for t in LENGTHS]
        mean = rs.randn(N_MELS, 1).astype(np.float32)
        std = (rs.rand(N_MELS, 1) + 0.5).astype(np.float32)
        jax_save_speaker(str(root / "pre"), sid, mels, mean, std)
    model = JaxGenerator(n_mels=N_MELS, residual_channels=R)
    x = jnp.zeros((1, N_MELS, 64))
    g = {k: jax.tree.map(np.asarray, fast_init(model, seed, x, jnp.ones_like(x)))
         for k, seed in (("A2B", 1), ("B2A", 2))}
    jax_save_checkpoint(str(root / "ckpts" / "00003_state.npz"), {"g_params": g})
    return root, g


def _args(root, name, model_name):
    return ["--name", name, "--save_dir", str(root / "results"),
            "--preprocessed_data_dir", str(root / "pre"),
            "--ckpt_dir", str(root / "ckpts"), "--load_epoch", "3",
            "--model_name", model_name, "--n_mels", str(N_MELS),
            "--residual_channels", str(R)]


@pytest.mark.parametrize("model_name", ["generator_A2B", "generator_B2A"])
def test_conversion_matches_jax_cli(corpus, model_name, capsys):
    root, _ = corpus
    jax_main(_args(root, f"jax_{model_name}", model_name))
    main(_args(root, f"port_{model_name}", model_name) + ["--device", "cpu"])
    assert "wrote 3 conversions" in capsys.readouterr().out.splitlines()[-1]
    src, tgt = (("VCC2SF3", "VCC2TF1") if model_name == "generator_A2B"
                else ("VCC2TF1", "VCC2SF3"))
    for i, t in enumerate(LENGTHS):
        for kind in ("converted", "original"):
            stem = f"{i}-{kind}_{src}_to_{tgt}.npy"
            want = np.load(root / "results" / f"jax_{model_name}" / "converted_audio_3" / stem)
            got = np.load(root / "results" / f"port_{model_name}" / "converted_audio_3" / stem)
            assert got.shape == want.shape == (N_MELS, t)
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    with open(root / "results" / f"port_{model_name}" / "test_args.json") as f:
        assert json.load(f)["device"] == "cpu"


def test_cuda_without_a_gpu_raises_instead_of_running_on_cpu(corpus, monkeypatch):
    root, _ = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(_args(root, "port_nogpu", "generator_A2B") + ["--device", "cuda"])
    assert not glob.glob(str(root / "results" / "port_nogpu" / "converted_audio_3" / "*"))


def test_checkpoint_layouts_load(corpus, tmp_path):
    """The JAX trainer's dataclass layout (``.g_params/...``), the port's own
    writer, and a reference ``.pth.tar`` all give the same state_dict."""
    _, g = corpus

    @dataclasses.dataclass
    class State:
        g_params: dict

    save_checkpoint(str(tmp_path / "00001_state.npz"), State({"A2B": g["A2B"]}),
                    meta={"seed": 0})
    with np.load(tmp_path / "00001_state.npz") as z:
        assert any(k.startswith(".g_params/A2B/params/") for k in z.files)
    want = generator_params_from_jax(g["A2B"])
    sd = generator_params_from_jax(
        load_checkpoint_subtree(str(tmp_path / "00001_state.npz"), "g_params/A2B"))
    torch.save({"ckpt_info": {"epoch": 2}, "model_state": want},
               tmp_path / "00002_generator_A2B.pth.tar")
    sd_ref = load_generator_params(str(tmp_path), 2, "generator_A2B")
    for k, v in want.items():
        assert torch.equal(sd[k], v) and torch.equal(sd_ref[k], v), k
    back = generator_params_to_jax(sd)
    np.testing.assert_array_equal(back["params"]["conv1"]["conv"]["kernel"],
                                  g["A2B"]["params"]["conv1"]["conv"]["kernel"])


def test_speaker_files_cross_packages(tmp_path):
    rs = np.random.RandomState(1)
    mels = [rs.randn(4, t).astype(np.float32) for t in (5, 9)]
    mean, std = rs.randn(4, 1).astype(np.float32), rs.rand(4, 1).astype(np.float32)
    save_speaker(str(tmp_path), "S1", mels, mean, std)
    for load in (load_speaker, jax_load_speaker):
        got, m, s = load(str(tmp_path), "S1")
        for a, b in zip(got, mels):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(m, mean)
        np.testing.assert_array_equal(s, std)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "maskcyclegan_vc_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    names = {p.relative_to(REPO).as_posix() for p in files}
    for sub in ("cli/preprocess.py", "cli/test.py", "data/melspec.py", "data/audio_io.py",
                "data/griffin_lim.py", "eval/f0.py", "eval/mcep.py", "eval/metrics.py",
                "models/melgan.py", "ops/melspec.py", "ops/melgan_stack.py",
                "parallel/dist.py", "parallel/mesh.py", "parallel/stats.py",
                "data/synth.py", "data/native.py"):
        assert f"maskcyclegan_vc_tpu_torch/{sub}" in names, sub
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "maskcyclegan_vc_tpu"), (path, mod)
