"""The plain reference against the port's CPU path at small sizes: the
generator (whole and bucketed), the discriminator, one training step, the
sampler and MelGAN, on the benchmark's own seeded weights; and both, built
from each configuration, against the parameter counts it states."""

from __future__ import annotations

import glob
import os
import statistics
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from maskcyclegan_vc_tpu_torch.cli.test import make_convert_fn  # noqa: E402
from maskcyclegan_vc_tpu_torch.data.dataset import MelBank  # noqa: E402
from maskcyclegan_vc_tpu_torch.data.dataset import sample_batch as port_sample_batch  # noqa: E402
from maskcyclegan_vc_tpu_torch.data.dataset import step_generator  # noqa: E402
from maskcyclegan_vc_tpu_torch.models import Discriminator as PortD  # noqa: E402
from maskcyclegan_vc_tpu_torch.models import Generator as PortG  # noqa: E402
from maskcyclegan_vc_tpu_torch.models.melgan import MelGANGenerator  # noqa: E402
from maskcyclegan_vc_tpu_torch.train.schedules import ScheduleConfig  # noqa: E402
from maskcyclegan_vc_tpu_torch.train.state import TrainConfig, create_train_state  # noqa: E402
from maskcyclegan_vc_tpu_torch.train.step import make_train_step  # noqa: E402
from portbench import catalog, traffic  # noqa: E402
from portbench.paths import convert, train  # noqa: E402
from portbench.reference import precision  # noqa: E402
from portbench.reference.melgan import MelGAN  # noqa: E402
from portbench.reference.models import Discriminator, Generator  # noqa: E402
from portbench.reference.step import LOSSES, Reference, sample_batch  # noqa: E402

CFG = {"n_mels": 16, "residual_channels": 16, "num_residual_blocks": 6, "generator_lr": 2e-4,
       "discriminator_lr": 1e-4, "adam_b1": 0.5, "adam_b2": 0.999, "adam_eps": 1e-8,
       "cycle_loss_lambda": 10.0, "identity_loss_lambda": 5.0, "max_mask_len": 5,
       "vocoder": {"ngf": 8, "ratios": [8, 8, 2, 2], "n_residual_layers": 3,
                   "weight_gain": 1.5}}
SEED = 2 ** 31 + 11
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _load(module, weights, prefix=""):
    module.load_state_dict({n: weights[prefix + n] for n, _ in module.named_parameters()},
                           strict=True)
    return module


def test_generator_matches_the_port():
    w = train.make_weights(CFG, SEED, "cpu")
    port = _load(PortG(16, 16, device="cpu"), w, "G.A2B.")
    ref = _load(Generator(16, 16), w, "G.A2B.")
    x = torch.randn(3, 16, 32, generator=torch.Generator().manual_seed(1))
    mask = (torch.rand(3, 16, 32, generator=torch.Generator().manual_seed(2)) > 0.2).float()
    with torch.no_grad():
        torch.testing.assert_close(port(x, mask), ref(x, mask), **TOL)


@pytest.mark.parametrize("frames", [29, 40, 67])
def test_bucketed_conversion_matches_the_reference_at_the_utterance_length(frames):
    g_w, _ = convert.make_weights(CFG, SEED, "cpu")
    port = PortG(16, 16, device="cpu")
    port.load_state_dict(g_w)
    ref = Generator(16, 16)
    ref.load_state_dict(g_w)
    mel = torch.randn(16, frames, generator=torch.Generator().manual_seed(frames)).numpy()
    got = make_convert_fn(port.eval())(mel)
    x = torch.from_numpy(mel)[None]
    with torch.no_grad():
        want = ref(x, torch.ones_like(x))[0, :, :frames].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_discriminator_matches_the_port():
    w = train.make_weights(CFG, SEED, "cpu")
    port = _load(PortD(16, device="cpu"), w, "D.A.")
    ref = _load(Discriminator(16), w, "D.A.")
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        torch.testing.assert_close(port(x), ref(x)[:, 0], **TOL)


def test_sampler_draws_the_ports_batch_bit_for_bit():
    (a, la), (b, lb) = traffic.speakers({"utterances": 5, "utterance_frames": [40, 70]}, 16,
                                        SEED, "cpu")
    banks = (MelBank(a, la), MelBank(b, lb))
    for step in (0, 7):
        want = port_sample_batch(step_generator(SEED, step, "cpu"), *banks, 3, 32, 5)
        got = sample_batch(SEED, step, ((a, la), (b, lb)), 3, 32, 5)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_one_training_step_matches_the_port():
    """Losses, and each leaf's gradient as Adam's first moment holds it,
    except the biases ahead of an InstanceNorm, whose gradient is rounding."""
    w = train.make_weights(CFG, SEED, "cpu")
    sched = ScheduleConfig(n_samples=5, batch_size=2, identity_loss_lambda=5.0)
    tcfg = TrainConfig(schedule=sched, n_mels=16, num_frames=32, residual_channels=16)
    state = create_train_state(tcfg, 0, "cpu")
    for side, models in (("G", state.g), ("D", state.d)):
        for k, m in models.items():
            _load(m, w, f"{side}.{k}.")
    ref = Reference(CFG, w, "cpu")
    speakers = traffic.speakers({"utterances": 5, "utterance_frames": [40, 70]}, 16, SEED, "cpu")
    batch = sample_batch(SEED, 0, speakers, 2, 32, 5)
    _, metrics = make_train_step(tcfg)(state, batch)
    want, grads = ref.step(batch, 5.0)
    for k in LOSSES:
        assert abs(float(metrics[k]) - want[k]) <= 1e-4 * abs(want[k]), k
    got = {f"G.{k}.{n}": state.g_opt.state[p]["exp_avg"] / 0.5
           for k in ("A2B", "B2A") for n, p in state.g[k].named_parameters()}
    ref_g = dict(zip(ref.leaf_names(), grads))
    med = statistics.median(float(g.norm()) for g in ref_g.values())
    for k, g in got.items():
        if float(ref_g[k].norm()) >= 1e-3 * med:
            assert float((g - ref_g[k]).norm()) <= 1e-3 * max(float(ref_g[k].norm()), med), k


def test_melgan_matches_the_port():
    _, v_w = convert.make_weights(CFG, SEED, "cpu")
    port = MelGANGenerator(16, 8, device="cpu")
    port.load_state_dict(v_w)
    ref = MelGAN(16, CFG["vocoder"])
    ref.load_state_dict(v_w)
    mel = torch.randn(2, 16, 12, generator=torch.Generator().manual_seed(4)) - 2.0
    with torch.no_grad():
        got, want = port(mel), ref(mel)
    assert got.shape == want.shape == (2, 12 * 256)
    torch.testing.assert_close(got, want, **TOL)


def test_lower_precision_operands_move_the_reference():
    """The controls' rounding: TF32 moves a conversion by about 1e-3 of its
    scale, fp8 by more; the gradient still reaches every weight."""
    g_w, _ = convert.make_weights(CFG, SEED, "cpu")
    ref = Generator(16, 16)
    ref.load_state_dict(g_w)
    x = torch.randn(1, 16, 32, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = ref(x, torch.ones_like(x))
        gaps = {}
        for mode in ("tf32", "fp8"):
            with precision.operands(mode):
                got = ref(x, torch.ones_like(x))
                gaps[mode] = float((got - want).abs().max() / want.abs().max())
    assert 1e-5 < gaps["tf32"] < 1e-2 < gaps["fp8"]
    with precision.operands("fp8"):
        ref(x, torch.ones_like(x)).sum().backward()
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in ref.parameters())


def _count(module) -> int:
    return sum(p.numel() for p in module.parameters())


@pytest.mark.parametrize("name", sorted(os.path.basename(f)[:-5] for f in
                                        glob.glob(os.path.join(ROOT, "portbench", "configs",
                                                               "*.json"))))
def test_reference_and_port_built_from_a_configuration_have_its_parameter_counts(name):
    cfg = catalog.read_json("configs", name)
    shape = (cfg["n_mels"], cfg["residual_channels"], cfg["num_residual_blocks"])
    with torch.device("meta"):
        built = {"generator_params": (Generator(*shape), PortG(*shape, device="meta"))}
        if "discriminator_params" in cfg:
            ref_d = Discriminator(cfg["residual_channels"])
            built["discriminator_params"] = (ref_d, PortD(cfg["residual_channels"], device="meta"))
            live = PortD(cfg["residual_channels"], include_dead_params=False, device="meta")
            assert sum(p.numel() for p in ref_d.live_parameters()) == _count(live) == \
                cfg["discriminator_live_params"]
        if "vocoder" in cfg:
            voc = cfg["vocoder"]
            built["vocoder.params"] = (MelGAN(cfg["n_mels"], voc),
                                       MelGANGenerator(cfg["n_mels"], voc["ngf"], device="meta"))
    for key, (ref, port) in built.items():
        want = cfg["vocoder"]["params"] if key == "vocoder.params" else cfg[key]
        assert _count(ref) == _count(port) == want, key


def test_a_vocoder_the_program_cannot_build_is_refused():
    cfg = catalog.read_json("configs", "maskcyclegan-vc-melgan")
    tr = catalog.read_json("traffic", "f32-closed-2to6s")
    convert.check_program_fits(cfg, tr)
    for voc in ({"ratios": [8, 8, 4]}, {"n_residual_layers": 4}):
        with pytest.raises(ValueError, match="the program's MelGAN"):
            convert.check_program_fits({**cfg, "vocoder": {**cfg["vocoder"], **voc}}, tr)
    with pytest.raises(ValueError, match="float32"):
        convert.check_program_fits(cfg, {**tr, "dtype": "bfloat16"})
