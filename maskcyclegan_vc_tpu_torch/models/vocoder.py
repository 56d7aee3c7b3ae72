"""The port's neural vocoders behind one loader.

``load_vocoder`` reads a checkpoint file and tells its family by its keys: a
jik876/hifi-gan generator (``conv_pre``, ...) gives a
``hifigan.HiFiGANGenerator``, anything else is read as a melgan-neurips
generator (``model.N``) and gives a ``melgan.MelGANGenerator``. Both take the
port's log10 mels, so ``melgan.decode_mel`` decodes with either.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from maskcyclegan_vc_tpu_torch.models import hifigan, melgan


def load_vocoder(path: str, device) -> nn.Module:
    """The vocoder of a checkpoint file, in eval mode on ``device``: a
    melgan-neurips ``state_dict`` or pickled module (whose ``state_dict()`` is
    taken), or a jik876/hifi-gan generator checkpoint (``{"generator":
    state_dict}`` as its training writes ``g_NNNNNNNN``, or the
    ``state_dict`` alone), built at the widths its weights' shapes give. The
    file is a pickle: load only checkpoints from a trusted source."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd.get("generator"), Mapping):
        sd = sd["generator"]
    if any(k.startswith("conv_pre.") for k in sd):
        sd, n_mels, widths = hifigan.load_hifigan_state_dict(sd)
        vocoder = hifigan.HiFiGANGenerator(n_mels, widths, device=device)
    else:
        sd = melgan.load_melgan_state_dict(sd)
        vocoder = melgan.MelGANGenerator(n_mels=sd["conv_in.weight"].shape[1],
                                         ngf=sd["conv_out.weight"].shape[1], device=device)
    vocoder.load_state_dict(sd, strict=True)
    return vocoder.eval()
