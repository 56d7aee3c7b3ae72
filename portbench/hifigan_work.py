"""The operations of converting and decoding one utterance with HiFi-GAN,
counted on the plain reference as ``flops.conversion`` counts MelGAN's:
``FlopCounterMode`` over ``reference/models.Generator`` and
``reference/hifigan.HiFiGAN`` on meta tensors (nothing is computed), at the
utterance's own length. The HiFi-GAN's elementwise work (leaky ReLUs, the
residual adds, the mean of the three blocks) is not counted.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.hifigan import HiFiGAN
from portbench.reference.models import Generator


def conversion(cfg: dict, frames: int) -> Dict[str, float]:
    """{"generator": ..., "vocoder": ...} for one utterance of ``frames``
    frames."""
    with torch.device("meta"):
        gen = Generator(cfg["n_mels"], cfg["residual_channels"], cfg["num_residual_blocks"])
        voc = HiFiGAN(cfg["n_mels"], cfg["hifigan"])
    x = torch.empty((1, cfg["n_mels"], frames), device="meta")
    out = {}
    with torch.no_grad():
        for name, fn in (("generator", lambda: gen(x, x)), ("vocoder", lambda: voc(x))):
            with FlopCounterMode(display=False) as counter:
                fn()
            out[name] = float(counter.get_total_flops())
    return out
