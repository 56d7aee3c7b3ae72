"""Weights and training state between the JAX package's trees and the port's.

The JAX package keeps a flax tree, ``{"params": {...}}``, with HWIO conv
kernels; the port keeps the reference's state_dict, with OIHW (OIK) conv
weights and the reference's module names. ``generator_params_*`` and
``discriminator_params_*`` map one onto the other (the same mapping as
``maskcyclegan_vc_tpu/io/torch_import.py``), on numpy leaves, and
``melgan_params_*`` do the same for the MelGAN vocoder.
``train_state_to_jax`` and ``train_state_from_jax`` carry a whole training
state (params, both Adams' moments and counts, the step) as the flat npz
keys the JAX trainer's checkpoint holds. ``load_pth_tar`` reads a reference
checkpoint.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from maskcyclegan_vc_tpu_torch.models.discriminator import DEAD_PREFIX


def _np(t) -> np.ndarray:
    """A numpy copy of a tensor (never a view of its storage), or the array."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True).numpy()
    return np.asarray(t)


def _num_residual_blocks(names) -> int:
    return len({m.group(1) for n in names
                if (m := re.match(r"residualLayer(\d+)(?:\.|$)", n))})


def _g_pairs(n_blocks: int):
    """(state_dict module, JAX tree path, kind) for every generator leaf owner."""
    out = [("conv1", ("conv1", "conv"), "2d"),
           ("conv1_gates", ("conv1_gates", "conv"), "2d")]
    for ds in ("downSample1", "downSample2"):
        out += [(f"{ds}.convLayer.0", (ds, "convLayer", "conv"), "2d"),
                (f"{ds}.convLayer.1", (ds, "convLayer_norm"), "norm"),
                (f"{ds}.convLayer_gates.0", (ds, "convLayer_gates", "conv"), "2d"),
                (f"{ds}.convLayer_gates.1", (ds, "convLayer_gates_norm"), "norm")]
    out += [("conv2dto1dLayer", ("conv2dto1dLayer", "conv"), "1d"),
            ("conv2dto1dLayer_tfan", ("conv2dto1dLayer_tfan",), "norm")]
    for i in range(1, n_blocks + 1):
        rl = f"residualLayer{i}"
        for conv, norm in (("conv1d_layer", "conv1d_layer_norm"),
                           ("conv_layer_gates", "conv_layer_gates_norm"),
                           ("conv1d_out_layer", "conv1d_out_layer_norm")):
            out += [(f"{rl}.{conv}.0", (rl, conv, "conv"), "1d"),
                    (f"{rl}.{conv}.1", (rl, norm), "norm")]
    out += [("conv1dto2dLayer", ("conv1dto2dLayer", "conv"), "1d"),
            ("conv1dto2dLayer_tfan", ("conv1dto2dLayer_tfan",), "norm"),
            ("upSample1.0", ("upSample1_conv", "conv"), "2d"),
            ("upSample1.2", ("upSample1_norm",), "norm"),
            ("upSample2.0", ("upSample2_conv", "conv"), "2d"),
            ("upSample2.2", ("upSample2_norm",), "norm"),
            ("lastConvLayer", ("lastConvLayer", "conv"), "2d")]
    return out


def _d_pairs(include_dead: bool):
    """The same for the discriminator. The dead block's four leaves sit
    directly under ``params``, named ``downSample4_conv_kernel`` etc."""
    out = [("convLayer1.0", ("convLayer1", "conv"), "2d")]
    for ds in ("downSample1", "downSample2", "downSample3"):
        out += [(f"{ds}.0", (ds, "convLayer", "conv"), "2d"),
                (f"{ds}.1", (ds, "norm"), "norm")]
    out.append(("outputConvLayer.0", ("outputConvLayer", "conv"), "2d"))
    if include_dead:
        out += [("downSample4.0", ("downSample4_conv_",), "dead2d"),
                ("downSample4.1", ("downSample4_norm_",), "deadnorm")]
    return out


# JAX kernel layout -> torch weight layout, and the leaf names on each side.
_TO_TORCH = {"2d": (3, 2, 0, 1), "dead2d": (3, 2, 0, 1), "1d": (2, 1, 0)}  # HWIO, KIO
_TO_JAX = {"2d": (2, 3, 1, 0), "dead2d": (2, 3, 1, 0), "1d": (2, 1, 0)}
_LEAVES = {"2d": ("kernel", "bias"), "dead2d": ("kernel", "bias"), "1d": ("kernel", "bias"),
           "norm": ("scale", "bias"), "deadnorm": ("scale", "bias")}


def _from_jax(p: Mapping, pairs) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for name, path, kind in pairs:
        if kind.startswith("dead"):
            w, b = (_np(p[path[0] + k]) for k in _LEAVES[kind])
        else:
            leaf = p
            for k in path:
                leaf = leaf[k]
            w, b = (_np(leaf[k]) for k in _LEAVES[kind])
        if kind in _TO_TORCH:
            w = w.transpose(_TO_TORCH[kind])
        sd[f"{name}.weight"] = torch.from_numpy(np.array(w, np.float32, order="C"))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(b, np.float32, order="C"))
    return sd


def _to_jax(sd: Mapping, pairs) -> Dict:
    p: Dict = {}
    for name, path, kind in pairs:
        w = _np(sd[f"{name}.weight"])
        if kind in _TO_JAX:
            w = w.transpose(_TO_JAX[kind])
        w, b = np.ascontiguousarray(w), _np(sd[f"{name}.bias"])
        kw, kb = _LEAVES[kind]
        if kind.startswith("dead"):
            p[path[0] + kw], p[path[0] + kb] = w, b
            continue
        node = p
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = {kw: w, kb: b}
    return {"params": p}


def generator_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``Generator`` params ``{"params": {...}}`` -> the port's state_dict."""
    p = tree["params"]
    return _from_jax(p, _g_pairs(_num_residual_blocks(p)))


def generator_params_to_jax(sd: Mapping) -> Dict:
    """The port's (or the reference's) state_dict -> JAX ``{"params": {...}}``
    with numpy leaves."""
    return _to_jax(sd, _g_pairs(_num_residual_blocks(sd)))


def discriminator_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``Discriminator`` params -> the port's state_dict, with the dead
    ``downSample4`` block where the tree holds it."""
    p = tree["params"]
    return _from_jax(p, _d_pairs("downSample4_conv_kernel" in p))


def discriminator_params_to_jax(sd: Mapping) -> Dict:
    """The port's (or the reference's) discriminator state_dict -> JAX
    params, with the dead leaves where the state_dict holds them."""
    return _to_jax(sd, _d_pairs(f"{DEAD_PREFIX}0.weight" in sd))


def _melgan_pairs(n_stages: int, n_residual_layers: int = 3):
    """(state_dict module, JAX leaf prefix, kind) for the MelGAN vocoder.
    The JAX tree keeps the transposed convs in torch's (I, O, K) layout."""
    out = [("conv_in", "conv_in", "1d")]
    for i in range(n_stages):
        out.append((f"ups.{i}", f"up{i}", "transpose"))
        for j in range(n_residual_layers):
            out += [(f"stages.{i}.{j}.{c}", f"res{i}_{j}_{c}", "1d")
                    for c in ("conv1", "conv2", "shortcut")]
    out.append(("conv_out", "conv_out", "1d"))
    return out


def melgan_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``MelGANGenerator`` params ``{"params": {conv_in_kernel (K, I, O),
    up{i}_kernel (I, O, K), res{i}_{j}_conv1_kernel, ...}}`` -> the port's
    state_dict."""
    p = tree["params"]
    n_stages = len({k.split("_")[0] for k in p if re.match(r"up\d+_kernel$", k)})
    sd: Dict[str, torch.Tensor] = {}
    for name, prefix, kind in _melgan_pairs(n_stages):
        w = _np(p[f"{prefix}_kernel"])
        if kind == "1d":
            w = w.transpose(_TO_TORCH["1d"])
        sd[f"{name}.weight"] = torch.from_numpy(np.array(w, np.float32, order="C"))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(_np(p[f"{prefix}_bias"]),
                                                       np.float32, order="C"))
    return sd


def melgan_params_to_jax(sd: Mapping) -> Dict:
    """The port's MelGAN state_dict -> JAX ``{"params": {...}}``, numpy leaves."""
    n_stages = len({k.split(".")[1] for k in sd if k.startswith("ups.")})
    p: Dict[str, np.ndarray] = {}
    for name, prefix, kind in _melgan_pairs(n_stages):
        w = _np(sd[f"{name}.weight"])
        if kind == "1d":
            w = w.transpose(_TO_JAX["1d"])
        p[f"{prefix}_kernel"] = np.ascontiguousarray(w)
        p[f"{prefix}_bias"] = _np(sd[f"{name}.bias"])
    return {"params": p}


# ---------------------------------------------------------------------------
# Whole training state <-> the JAX trainer's checkpoint keys
# ---------------------------------------------------------------------------
#
#   .step                                         int32
#   .g_params/<A2B|B2A>/params/...                the generators
#   .d_params/<A|B|A2|B2>/params/...              the discriminators, dead leaves too
#   .g_opt/0/.count, .g_opt/1/.count              optax chain(scale_by_adam,
#   .g_opt/0/.mu/<A2B|B2A>/params/..., .nu/...      scale_by_schedule): counts, moments
#   .d_opt/.inner_state/0/.count, .../1/.count    the same under optax.masked, whose
#   .d_opt/.inner_state/0/.mu/<A|...>/params/...    MaskedNode leaves no dead moments
#
# Both counts of an optimizer equal the number of updates it made, which is
# torch Adam's per-parameter ``step``. Moments follow their weights' layout.

_G_OPT, _D_OPT = ".g_opt/", ".d_opt/.inner_state/"


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _flatten(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = v


def _subtree(flat: Mapping, prefix: str) -> Dict:
    out: Dict = {}
    for k, v in flat.items():
        if k.startswith(prefix + "/"):
            d = out
            parts = k[len(prefix) + 1:].split("/")
            for s in parts[:-1]:
                d = d.setdefault(s, {})
            d[parts[-1]] = v
    if not out:
        raise KeyError(f"no leaves under {prefix!r}")
    return out


def _moments(opt: torch.optim.Optimizer, module: torch.nn.Module, key: str):
    """The module's live parameters' Adam moment (``exp_avg`` or
    ``exp_avg_sq``) as a state_dict, zeros where Adam has made no step yet."""
    out = {}
    for name, p in module.named_parameters():
        if name.startswith(DEAD_PREFIX):
            continue
        st = opt.state.get(p)
        out[name] = st[key] if st else torch.zeros_like(p)
    return out


def _count(opt: torch.optim.Optimizer) -> int:
    """The optimizer's step count, read in one transfer (a capturable Adam
    keeps each parameter's on the device)."""
    if not opt.state:
        return 0
    steps = set(torch.stack([st["step"] for st in opt.state.values()]).cpu().tolist())
    if len(steps) > 1:
        raise ValueError(f"parameters of one optimizer at different steps: {steps}")
    return int(steps.pop())


def train_state_to_jax(state) -> Dict[str, np.ndarray]:
    """A ``train.state.TrainState`` -> the flat npz entries the JAX trainer's
    ``save_checkpoint(TrainState)`` writes. Every array is a host copy, safe
    to write out while training goes on."""
    flat: Dict[str, np.ndarray] = {".step": np.asarray(state.step, np.int32)}
    sides = ((".g_params", _G_OPT, state.g, state.g_opt, generator_params_to_jax),
             (".d_params", _D_OPT, state.d, state.d_opt, discriminator_params_to_jax))
    for params_key, opt_key, models, opt, to_jax in sides:
        for name, model in models.items():
            _flatten(to_jax(model.state_dict()), f"{params_key}/{name}", flat)
            for moment, key in ((".mu", "exp_avg"), (".nu", "exp_avg_sq")):
                _flatten(to_jax(_moments(opt, model, key)),
                         f"{opt_key}0/{moment}/{name}", flat)
        count = _count(opt)
        for i in (0, 1):
            flat[f"{opt_key}{i}/.count"] = np.asarray(count, np.int32)
    return flat


def train_state_from_jax(flat: Mapping, state):
    """Load the flat npz entries of a JAX trainer's checkpoint (or of
    ``train_state_to_jax``) into ``state`` in place, and return it."""
    state.step = int(flat[".step"])
    sides = ((".g_params", _G_OPT, state.g, state.g_opt, generator_params_from_jax),
             (".d_params", _D_OPT, state.d, state.d_opt, discriminator_params_from_jax))
    for params_key, opt_key, models, opt, from_jax in sides:
        counts = {int(flat[f"{opt_key}{i}/.count"]) for i in (0, 1)}
        if len(counts) != 1:
            raise ValueError(f"{opt_key}: Adam and schedule counts differ: {counts}")
        count = counts.pop()
        # Where Adam's own first step would put its count: on the
        # parameter's device for a capturable Adam, else on the CPU.
        on_device = opt.defaults["capturable"]
        for name, model in models.items():
            model.load_state_dict(from_jax(_subtree(flat, f"{params_key}/{name}")),
                                  strict=True)
            mu, nu = (from_jax(_subtree(flat, f"{opt_key}0/{m}/{name}"))
                      for m in (".mu", ".nu"))
            for pname, p in model.named_parameters():
                if not pname.startswith(DEAD_PREFIX):
                    opt.state[p] = {"step": torch.tensor(
                                        float(count), device=p.device if on_device else "cpu"),
                                    "exp_avg": mu[pname].to(p.device),
                                    "exp_avg_sq": nu[pname].to(p.device)}
    return state


def load_pth_tar(path: str):
    """Read a reference ``.pth.tar`` checkpoint; returns (state_dict, epoch).

    Layout: {'ckpt_info': {'epoch': N}, 'model_state': state_dict, ...}.
    The file is a pickle: load only checkpoints from a trusted source.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt["model_state"], ckpt.get("ckpt_info", {}).get("epoch")
