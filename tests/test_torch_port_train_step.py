"""Port's schedules, loss graph, train step and training state against JAX's.

Both packages start from the same state: the JAX ``create_train_state`` of
``tiny_cfg``'s schedule and widths (as ``tests/test_train_step.py`` sizes
them: batch 2, R = 8), carried into the port through the JAX trainer's
checkpoint. The batches are 16 mels x 32 frames, not tiny_cfg's 8 x 8:
there the residual stack's InstanceNorms normalise over 2 frames and the
discriminator's last one over a single position, where the gradient is
exactly zero or so ill-conditioned that rounding differences reach 3e-3.
The JAX side runs its XLA f32 path (``precision="highest"``,
``fused_norms=False``: the same functions as its Pallas norms, whose
gradients ``test_torch_port_train_ops.py`` pins); the port runs on the CPU
through its autograd Functions.

Tolerances. Losses of one step's G graph from one state: rtol 1e-5 (f32,
sums in another order). Gradients through that whole graph: 2e-4 of the
largest gradient of the leaf's layer (``assert_grads_close``); between a
leaf and the loss lie up to two generators and a discriminator, some 45
InstanceNorms, whose residual-stack norms cover 8 frames at this size, and
they amplify rounding differences: the worst leaf measures 4.7e-5, a wrong
backward gives O(1) (``tests/test_dynamics_parity.py`` uses 5e-4 at full
size for the same reason). Single models and kernels hold at 1e-5 in
their own test files. The optimizer: Adam's moments per leaf on the same
layer scale, and each update where the gradient is clear of rounding
within 1e-2 lr (``assert_adam_matches``). Params everywhere: Adam's first
update is close to lr * sign(g), so a rounding difference can flip the
sign of a near-zero gradient and put the two packages' params 2 lr apart;
a second update adds at most 1.06 lr per side (|m_hat| / sqrt(v_hat) <=
1.06 at t = 2 for b1 = 0.5, b2 = 0.999): the bounds are 2.02 lr after one
step and 4.2 lr after two, with a margin for the f32 rounding of the
params. That bound is a guard on the rare flips only; no wrong gradient
or optimizer could exceed it. Metrics computed after an update (the D
step's losses, which see the updated generators, and every loss of a
later step) inherit those param differences: rtol 1e-3 (the repo's own
loss-trajectory pin uses 2e-3).

In f64 on both sides the same G graph's gradients hold at 1e-5 of each
layer's largest, the slice's bound for single models
(``test_g_graph_gradients_match_jax_in_f64``): the 2e-4 above is f32
rounding amplified by the chained norms, not a difference of formulas.
Measured: within 1e-9.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskcyclegan_vc_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from maskcyclegan_vc_tpu.models import discriminator as jax_discriminator_module
from maskcyclegan_vc_tpu.models import generator as jax_generator_module
from maskcyclegan_vc_tpu.ops import layers as jax_layers_module
from maskcyclegan_vc_tpu.ops import tap_conv as jax_tap_conv_module
from maskcyclegan_vc_tpu.train import step as jax_step_module
from maskcyclegan_vc_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from maskcyclegan_vc_tpu.train import schedules as jax_schedules
from maskcyclegan_vc_tpu.train.state import TrainConfig as JaxTrainConfig
from maskcyclegan_vc_tpu.train.state import create_train_state as jax_create_train_state
from maskcyclegan_vc_tpu.train.step import make_jit_train_step as jax_make_train_step
from maskcyclegan_vc_tpu.train.step import make_loss_fns as jax_make_loss_fns
from maskcyclegan_vc_tpu_torch.io.checkpoint import (
    load_checkpoint_meta,
    load_train_state,
    save_train_state,
)
from maskcyclegan_vc_tpu_torch.io.jax_params import (
    discriminator_params_to_jax,
    generator_params_to_jax,
    train_state_to_jax,
)
from maskcyclegan_vc_tpu_torch.train import schedules
from maskcyclegan_vc_tpu_torch.train.state import TrainConfig, create_train_state
from maskcyclegan_vc_tpu_torch.train.step import make_loss_fns, make_train_step
from test_torch_port_discriminator import assert_grads_close

torch.set_num_threads(1)
SCHED = dict(num_epochs=10, n_samples=4, batch_size=2, decay_after=4, stop_identity_after=4)
N_MELS, FRAMES, R = 16, 32, 8


def jax_cfg(**over):
    sched = dict(SCHED, **over.pop("sched", {}))
    return JaxTrainConfig(schedule=jax_schedules.ScheduleConfig(**sched), n_mels=N_MELS,
                          num_frames=FRAMES, residual_channels=R, precision="highest",
                          **over)


def port_cfg(cfg: JaxTrainConfig) -> TrainConfig:
    return TrainConfig(schedule=schedules.ScheduleConfig(**dataclasses.asdict(cfg.schedule)),
                       n_mels=cfg.n_mels, num_frames=cfg.num_frames,
                       residual_channels=cfg.residual_channels, remat=cfg.remat,
                       pair_forwards=cfg.pair_forwards)


def batch(seed, b=2):
    rs = np.random.RandomState(seed)
    mask = np.ones((b, N_MELS, FRAMES), np.float32)
    mask[0, :, 2:5] = 0.0
    return {"real_A": rs.randn(b, N_MELS, FRAMES).astype(np.float32), "mask_A": mask,
            "real_B": rs.randn(b, N_MELS, FRAMES).astype(np.float32),
            "mask_B": np.ascontiguousarray(mask[::-1])}


def torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def port_state_from_jax(jax_state, cfg, path):
    """The port's state loaded from the JAX trainer's checkpoint of jax_state."""
    jax_save_checkpoint(str(path), jax.device_get(jax_state))
    return load_train_state(str(path), create_train_state(cfg, seed=7))


def jax_flat(state):
    """The JAX trainer's checkpoint entries of a state, as numpy."""
    from maskcyclegan_vc_tpu.io.checkpoint import _flatten

    return _flatten(jax.device_get(state))


MOMENTS = {"g": ".g_opt/0/", "d": ".d_opt/.inner_state/0/"}  # optax state prefixes


def _layer(key):
    return key.rsplit("/", 1)[0]


def _layer_max(flat, keys):
    """The largest |value| of each layer's leaves (a conv's kernel and bias,
    a norm's scale and bias)."""
    scale = {}
    for k in keys:
        scale[_layer(k)] = max(scale.get(_layer(k), 0.0), float(np.abs(flat[k]).max()))
    return scale


def assert_adam_matches(want, got, want_prev, got_prev, lrs):
    """One optimizer step of two states, as the JAX trainer's checkpoint
    entries after it and before it, against each other.

    Moments per leaf within a bound on the scale of the leaf's layer, as
    the gradients are held (``assert_grads_close``): at t = 1 mu =
    (1 - b1) g and nu = (1 - b2) g^2, so they pin b1, b2 and the gradients
    (2e-4; nu, a square, doubles the relative error: 4e-4). Updates
    p_after - p_before per element within 1e-2 lr where the gradient is
    clear of rounding (|mu| above 1e-2 of its layer's largest), where both
    sides' updates have one sign: this pins lr and the step count it is
    taken at (the linear decay moves lr by 5e-2 per step here), the bias
    correction and the update's sign. Measured: moments within 6.5e-5 of
    the layer scale, updates within 1.2e-3 lr (the f32 spacing of a param
    near 1 is 6e-4 lr). eps = 1e-8 lies far below these gradients, so its
    place after the square root is not pinned here (an eps of 1e-4 is)."""
    for side, lr in lrs.items():
        pre = MOMENTS[side]
        for mom, tol in ((".mu/", 2e-4), (".nu/", 4e-4)):
            keys = [k for k in want if k.startswith(pre + mom)]
            assert keys and {k for k in got if k.startswith(pre + mom)} == set(keys)
            scale = _layer_max(want, keys)
            for k in keys:
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=tol * scale[_layer(k)], err_msg=k)
        mu_keys = [k for k in want if k.startswith(pre + ".mu/")]
        scale = _layer_max(want, mu_keys)
        n_clear = 0
        for mk in mu_keys:
            pk = f".{side}_params/" + mk[len(pre + ".mu/"):]
            clear = np.abs(want[mk]) > 1e-2 * scale[_layer(mk)]
            n_clear += int(clear.sum())
            np.testing.assert_allclose((got[pk] - got_prev[pk])[clear],
                                       (want[pk] - want_prev[pk])[clear],
                                       rtol=0, atol=1e-2 * lr, err_msg=pk)
        assert n_clear > 0.5 * sum(want[k].size for k in mu_keys), side


# ---------- schedules ----------

@pytest.mark.parametrize("over", [
    dict(batch_size=2, decay_after=8, n_samples=10, num_epochs=3),
    dict(batch_size=1, decay_after=5, n_samples=10, num_epochs=3, ref_compat_lr=True),
    dict(batch_size=3, decay_after=20, stop_identity_after=30, n_samples=7, num_epochs=2),
])
def test_schedules_match_jax(over):
    jc = jax_schedules.ScheduleConfig(**over)
    pc = schedules.ScheduleConfig(**over)
    for step in range(41):
        for name in ("generator_lr", "discriminator_lr", "identity_lambda"):
            want = float(getattr(jax_schedules, name)(jc, step))
            got = getattr(schedules, name)(pc, step)
            assert isinstance(got, float)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12, err_msg=f"{name} {step}")


# ---------- one loss graph ----------

def test_losses_and_gradients_match_jax_loss_fns(tmp_path):
    """tiny_cfg's batch of 2, so pair_forwards is on (auto below 16)."""
    cfg = jax_cfg()
    js = jax_create_train_state(cfg, seed=0)
    ps = port_state_from_jax(js, port_cfg(cfg), tmp_path / "00000_state.npz")
    b = batch(1)
    _, _, g_loss_fn, d_loss_fn = jax_make_loss_fns(cfg)
    (g_loss, g_aux), g_grads = jax.jit(jax.value_and_grad(g_loss_fn, has_aux=True))(
        js.g_params, js.d_params, b, 5.0)
    pg, pd = make_loss_fns(port_cfg(cfg))
    got_loss, got_aux = pg(ps.g, ps.d, torch_batch(b), 5.0)
    np.testing.assert_allclose(got_loss.item(), float(g_loss), rtol=1e-5)
    for k in g_aux:
        np.testing.assert_allclose(got_aux[k].item(), float(g_aux[k]), rtol=1e-5, err_msg=k)
    for name in ("A2B", "B2A"):
        gen = ps.g[name]
        grads = torch.autograd.grad(got_loss, list(gen.parameters()), retain_graph=True)
        got = generator_params_to_jax(dict(zip([n for n, _ in gen.named_parameters()], grads)))
        assert_grads_close(got, g_grads[name], 2e-4)

    rs = np.random.RandomState(2)
    fakes = {k: rs.randn(2, N_MELS, FRAMES).astype(np.float32)
             for k in ("generated_A", "generated_B", "cycled_A", "cycled_B")}
    (d_loss, d_aux), d_grads = jax.jit(jax.value_and_grad(d_loss_fn, has_aux=True))(
        js.d_params, fakes, b)
    got_loss, got_aux = pd(ps.d, torch_batch(fakes), torch_batch(b))
    np.testing.assert_allclose(got_loss.item(), float(d_loss), rtol=1e-5)
    for k in d_aux:
        np.testing.assert_allclose(got_aux[k].item(), float(d_aux[k]), rtol=1e-5, err_msg=k)
    for name in ("A", "B", "A2", "B2"):
        d = ps.d[name]
        names = [n for n, _ in d.named_parameters() if not n.startswith("downSample4.")]
        grads = torch.autograd.grad(got_loss, d.live_parameters(), retain_graph=True)
        assert_grads_close(discriminator_params_to_jax(dict(zip(names, grads))), d_grads[name])


class _Float64Numpy(types.ModuleType):
    """``jax.numpy`` with ``float32`` read as ``float64``."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_g_graph_gradients_match_jax_in_f64(tmp_path, monkeypatch):
    """The G loss graph's gradients, both generators, in f64 on both sides,
    held at 1e-5 of each layer's largest gradient (the f32 test above holds
    2e-4). JAX runs under ``jax.enable_x64`` with ``fused_norms=False``. Its
    norm statistics, generator output, discriminator sigmoid and losses are
    pinned to f32 by ``jnp.float32``; here that name reads float64 in the
    modules that use it, through ``monkeypatch``, so the same graph runs in
    f64 (no file of the JAX package changes). The port runs its plain
    versions on the CPU, which compute in f64 from f64 values
    (``ops.in_gate.widened``); its kernel entries refuse f64."""
    cfg = jax_cfg(fused_norms=False)
    js = jax_create_train_state(cfg, seed=0)
    pcfg = dataclasses.replace(port_cfg(cfg), fused_norms=False)
    ps = port_state_from_jax(js, pcfg, tmp_path / "00000_state.npz")
    b = batch(1)

    def f64(tree):
        return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)

    with jax.enable_x64(True):
        for module in (jax_layers_module, jax_tap_conv_module, jax_generator_module,
                       jax_discriminator_module, jax_step_module):
            monkeypatch.setattr(module, "jnp", _Float64Numpy("jnp_float64"))
        _, _, g_loss_fn, _ = jax_make_loss_fns(cfg)
        (g_loss, _), g_grads = jax.jit(jax.value_and_grad(g_loss_fn, has_aux=True))(
            f64(js.g_params), f64(js.d_params), f64(b), 5.0)
        assert g_loss.dtype == jnp.float64
        assert all(leaf.dtype == jnp.float64 for leaf in jax.tree.leaves(g_grads))
    monkeypatch.undo()

    for model in (*ps.g.values(), *ps.d.values()):
        model.double()
    pg, _ = make_loss_fns(pcfg)
    got_loss, _ = pg(ps.g, ps.d, {k: v.double() for k, v in torch_batch(b).items()}, 5.0)
    assert got_loss.dtype == torch.float64
    np.testing.assert_allclose(got_loss.item(), float(g_loss), rtol=1e-12)
    for name in ("A2B", "B2A"):
        gen = ps.g[name]
        grads = torch.autograd.grad(got_loss, list(gen.parameters()), retain_graph=True)
        got = generator_params_to_jax(dict(zip([n for n, _ in gen.named_parameters()], grads)))
        assert_grads_close(got, g_grads[name], 1e-5)


# ---------- whole steps ----------

G_STEP_METRICS = ("g_loss", "g_adv_loss", "g_cycle_loss", "g_identity_loss", "identity_lambda")


@pytest.fixture(scope="module")
def trajectory(tmp_path_factory):
    """JAX and port states and metrics after each of two consecutive steps
    from one start, and the start's checkpoint entries. The identity cutoff
    falls between them (stop_identity_after 1 at batch 2: step 0 with
    identity, step 1 without): the port switches to its no-identity step
    there, as its trainer does; JAX runs its with-identity step, whose
    identity terms weigh 0 past the cutoff (its own tests pin the two JAX
    steps equal there). The lr decay starts between them too (decay_after
    0: step 0 at the base lr, step 1 at 0.95 of it)."""
    cfg = jax_cfg(sched=dict(stop_identity_after=1, decay_after=0))
    cutoff = cfg.schedule.stop_identity_after // cfg.schedule.batch_size
    js = jax_create_train_state(cfg, seed=0)
    start = jax_flat(js)
    ps = port_state_from_jax(js, port_cfg(cfg), tmp_path_factory.mktemp("traj") / "s.npz")
    jax_step = jax_make_train_step(cfg, with_identity=True)
    port_steps = {wi: make_train_step(port_cfg(cfg), wi) for wi in (True, False)}
    out = []
    for i in range(2):
        b = batch(10 + i)
        js, jm = jax_step(jax.device_get(js), b)
        ps, pm = port_steps[i <= cutoff](ps, torch_batch(b))
        out.append((jax_flat(js), {k: float(v) for k, v in jm.items()},
                    train_state_to_jax(ps), {k: v.item() for k, v in pm.items()}))
    return cfg, out, jax.device_get(js), ps, start


def step_lrs(cfg, step):
    sched = schedules.ScheduleConfig(**dataclasses.asdict(cfg.schedule))
    return {"g": schedules.generator_lr(sched, step), "d": schedules.discriminator_lr(sched, step)}


def test_step_metrics_match_jax(trajectory):
    _, out, _, _, _ = trajectory
    for i, (_, jm, _, pm) in enumerate(out):
        assert pm.keys() == jm.keys()
        for k in jm:
            rtol = 1e-5 if i == 0 and k in G_STEP_METRICS else 1e-3
            np.testing.assert_allclose(pm[k], jm[k], rtol=rtol, atol=1e-7,
                                       err_msg=f"step {i} {k}")
    assert [m["identity_lambda"] for _, _, _, m in out] == [5.0, 0.0]
    assert out[0][3]["g_identity_loss"] > 0 and out[1][3]["g_identity_loss"] == 0.0


def test_step_adam_matches_jax(trajectory):
    """Both steps' moments and updates against optax's, the second at the
    decayed lr."""
    cfg, out, _, _, start = trajectory
    lrs = [step_lrs(cfg, i) for i in range(2)]
    assert lrs[1]["g"] == pytest.approx(0.95 * lrs[0]["g"])
    prev = (start, start)
    for i, (jf, _, pf, _) in enumerate(out):
        assert_adam_matches(jf, pf, *prev, lrs[i])
        prev = (jf, pf)


def test_step_params_within_the_adam_quantum(trajectory):
    cfg, out, _, _, _ = trajectory
    for i, (jf, _, pf, _) in enumerate(out):
        assert pf.keys() == jf.keys()
        assert int(pf[".step"]) == int(jf[".step"]) == i + 1
        for side, lr in (("g", cfg.schedule.generator_lr), ("d", cfg.schedule.discriminator_lr)):
            bound = (2.02 if i == 0 else 4.2) * lr
            for k in (k for k in jf if k.startswith(f".{side}_params/")):
                np.testing.assert_allclose(pf[k], jf[k], rtol=0, atol=bound,
                                           err_msg=f"step {i} {k}")
        for k in (k for k in jf if k.endswith("/.count")):
            assert int(pf[k]) == int(jf[k]) == i + 1, k


def test_dead_params_untouched_and_without_moments(trajectory):
    _, out, _, ps, _ = trajectory
    last = out[-1][2]
    dead = [k for k in last if "downSample4" in k]
    assert len(dead) == 4 * 4 and all(k.startswith(".d_params/") for k in dead)
    for k in dead:
        np.testing.assert_array_equal(last[k], out[-1][0][k])
    assert all(p not in ps.d_opt.state for d in ps.d.values()
               for n, p in d.named_parameters() if n.startswith("downSample4."))


def test_port_checkpoint_loads_in_jax(trajectory, tmp_path):
    cfg, _, _, ps, _ = trajectory
    path = str(tmp_path / "00003_state.npz")
    save_train_state(path, ps, meta={"seed": 0, "epoch": 3})
    loaded = jax_load_checkpoint(path, jax_create_train_state(cfg, seed=9))
    want = train_state_to_jax(ps)
    got = jax_flat(loaded)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert {k: int(v) for k, v in load_checkpoint_meta(path).items()} == {"seed": 0, "epoch": 3}


def test_jax_checkpoint_loads_in_port(trajectory, tmp_path):
    cfg, out, js, _, _ = trajectory
    path = str(tmp_path / "00003_state.npz")
    jax_save_checkpoint(path, js, meta={"seed": 0})
    ps = load_train_state(path, create_train_state(port_cfg(cfg), seed=5))
    got, want = train_state_to_jax(ps), out[-1][0]
    assert got.keys() == want.keys() and ps.step == len(out)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _port_step(tmp_path, cfg, name, start=0, **over):
    pc = dataclasses.replace(port_cfg(cfg), **{k: v for k, v in over.items()
                                               if k != "with_identity"})
    js = jax_create_train_state(cfg, seed=0).replace(step=jax.numpy.asarray(start, "int32"))
    ps = port_state_from_jax(js, pc, tmp_path / f"{name}.npz")
    before = train_state_to_jax(ps)
    ps, m = make_train_step(pc, over.get("with_identity", True))(ps, torch_batch(batch(3)))
    return train_state_to_jax(ps), {k: v.item() for k, v in m.items()}, before


def _assert_same_step(a, b, lrs):
    """Metrics at rtol 1e-5, Adam by ``assert_adam_matches``, and every
    param within the first step's quantum (2.02 lr, the module's note)."""
    for k in a[1]:
        np.testing.assert_allclose(b[1][k], a[1][k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert_adam_matches(a[0], b[0], a[2], b[2], lrs)
    for side, lr in lrs.items():
        for k in (k for k in a[0] if k.startswith(f".{side}_params/")):
            np.testing.assert_allclose(b[0][k], a[0][k], rtol=0, atol=2.02 * lr, err_msg=k)


def test_port_variants_compute_the_same_step(tmp_path):
    """pair_forwards off against on, and remat (each G forward of the G step
    recomputed in its backward) against none: the same step. Past the
    cutoff, the step with identity terms (weighted 0) against the step
    without them, the switch the trainer makes; that step also runs at a
    decayed lr (past decay_after)."""
    cfg = jax_cfg()
    base = _port_step(tmp_path, cfg, "base")
    lrs = step_lrs(cfg, 0)
    _assert_same_step(base, _port_step(tmp_path, cfg, "unpaired", pair_forwards=False), lrs)
    _assert_same_step(base, _port_step(tmp_path, cfg, "remat", remat=True), lrs)
    past = 1 + cfg.schedule.stop_identity_after // cfg.schedule.batch_size
    assert step_lrs(cfg, past)["g"] < lrs["g"]
    on = _port_step(tmp_path, cfg, "on", start=past)
    off = _port_step(tmp_path, cfg, "off", start=past, with_identity=False)
    assert on[1]["identity_lambda"] == off[1]["identity_lambda"] == 0.0
    assert on[1]["g_identity_loss"] == 0.0
    _assert_same_step(on, off, step_lrs(cfg, past))
