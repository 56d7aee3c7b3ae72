"""Generator weights between the JAX package's tree and the port's state_dict.

The JAX package keeps a flax tree, ``{"params": {...}}``, with HWIO conv
kernels; the port keeps the reference's state_dict, with OIHW (OIK) conv
weights and the reference's module names. These two functions map one onto
the other (the same mapping as ``maskcyclegan_vc_tpu/io/torch_import.py``),
on numpy leaves, and ``load_pth_tar`` reads a reference checkpoint.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _num_residual_blocks(names) -> int:
    return len({m.group(1) for n in names
                if (m := re.match(r"residualLayer(\d+)(?:\.|$)", n))})


def _pairs(n_blocks: int):
    """(state_dict module, JAX tree path, kind) for every leaf owner."""
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


# JAX kernel layout -> torch weight layout, and the leaf names on each side.
_TO_TORCH = {"2d": (3, 2, 0, 1), "1d": (2, 1, 0)}  # HWIO -> OIHW, KIO -> OIK
_TO_JAX = {"2d": (2, 3, 1, 0), "1d": (2, 1, 0)}
_LEAVES = {"2d": ("kernel", "bias"), "1d": ("kernel", "bias"), "norm": ("scale", "bias")}


def generator_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``Generator`` params ``{"params": {...}}`` -> the port's state_dict."""
    p = tree["params"]
    sd: Dict[str, torch.Tensor] = {}
    for name, path, kind in _pairs(_num_residual_blocks(p)):
        leaf = p
        for k in path:
            leaf = leaf[k]
        w, b = (_np(leaf[k]) for k in _LEAVES[kind])
        if kind in _TO_TORCH:
            w = w.transpose(_TO_TORCH[kind])
        sd[f"{name}.weight"] = torch.from_numpy(np.array(w, np.float32, order="C"))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(b, np.float32, order="C"))
    return sd


def generator_params_to_jax(sd: Mapping) -> Dict:
    """The port's (or the reference's) state_dict -> JAX ``{"params": {...}}``
    with numpy leaves."""
    p: Dict = {}
    for name, path, kind in _pairs(_num_residual_blocks(sd)):
        w = _np(sd[f"{name}.weight"])
        if kind in _TO_JAX:
            w = w.transpose(_TO_JAX[kind])
        node = p
        for k in path[:-1]:
            node = node.setdefault(k, {})
        kw, kb = _LEAVES[kind]
        node[path[-1]] = {kw: np.ascontiguousarray(w), kb: _np(sd[f"{name}.bias"])}
    return {"params": p}


def load_pth_tar(path: str):
    """Read a reference ``.pth.tar`` checkpoint; returns (state_dict, epoch).

    Layout: {'ckpt_info': {'epoch': N}, 'model_state': state_dict, ...}.
    The file is a pickle: load only checkpoints from a trusted source.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt["model_state"], ckpt.get("ckpt_info", {}).get("epoch")
