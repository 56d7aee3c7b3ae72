"""The operations of the benchmark's work, counted on the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions and
matrix products that the reference performs for the same inputs, on meta
tensors (nothing is computed), forward and backward, with nothing
recomputed. So the count is the same whatever implements the work, and a
faster program raises its share of the peak only by taking less time.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.melgan import MelGAN
from portbench.reference.models import Generator
from portbench.reference.step import Reference


def train_step(cfg: dict, batch: int, frames: int) -> float:
    """Operations of one training step with the identity loss at ``batch``
    x ``frames``: the G loss and its gradient in the G parameters, then
    the D loss (its conversions without gradient) and its gradient in the D
    parameters. Adam's elementwise update is not counted."""
    ref = Reference(cfg)
    shape = (batch, cfg["n_mels"], frames)
    b = {k: torch.empty(shape, device="meta") for k in ("real_A", "mask_A", "real_B", "mask_B")}
    with FlopCounterMode(display=False) as counter:
        loss, _ = ref.g_loss(b, cfg["identity_loss_lambda"])
        torch.autograd.grad(loss, ref.g_params())
        loss, _ = ref.d_loss(b)
        torch.autograd.grad(loss, ref.d_params())
    return float(counter.get_total_flops())


def conversion(cfg: dict, frames: int) -> Dict[str, float]:
    """Operations of converting and decoding one utterance of ``frames``
    frames at its own length: {"generator": ..., "vocoder": ...}."""
    voc = cfg["vocoder"]
    with torch.device("meta"):
        gen = Generator(cfg["n_mels"], cfg["residual_channels"], cfg["num_residual_blocks"])
        mel = MelGAN(cfg["n_mels"], voc)
    x = torch.empty((1, cfg["n_mels"], frames), device="meta")
    out = {}
    with torch.no_grad():
        for name, fn in (("generator", lambda: gen(x, x)), ("vocoder", lambda: mel(x))):
            with FlopCounterMode(display=False) as counter:
                fn()
            out[name] = float(counter.get_total_flops())
    return out
