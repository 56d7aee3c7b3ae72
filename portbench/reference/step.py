"""MaskCycleGAN-VC's training iteration in plain PyTorch, and its sampler.

The iteration is GANtastic3/MaskCycleGAN-VC's ``train.py``: the generator
update first (six generator forwards, four discriminator forwards, LSGAN on
the sigmoid's probabilities, cycle L1 times ``cycle_loss_lambda``, identity
L1 times ``identity_loss_lambda``), then the discriminator update on the
updated generators' conversions, each side by ``torch.optim.Adam`` with
betas (0.5, 0.999). Each update takes its side's gradients alone, so no
gradient leaks from one side's loss into the other side's parameters.

The sampler draws the batch that MaskCycleGAN-VC's data loader describes:
per side and slot an utterance, a crop of ``frames`` frames at a uniform
start, and a frequency-insensitive mask (FIF) of a uniform size below
``max_mask_len`` at a uniform place. Its random numbers come from a
``torch.Generator`` seeded per step from (seed, step), drawn in the order
that the benchmark's training path documents, so that it draws the bits
that path draws.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.reference.models import Discriminator, Generator

LOSSES = ("g_loss", "d_loss", "g_adv_loss", "g_cycle_loss", "g_identity_loss",
          "d_loss_first", "d_loss_second")
G_NAMES = ("A2B", "B2A")
D_NAMES = ("A", "B", "A2", "B2")


def step_seed(seed: int, step: int) -> int:
    """The sampler's seed for one step: numpy's SeedSequence of (seed, step)."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return int(mixed) & (2 ** 63 - 1)


def sample_side(gen, data, lengths, batch: int, frames: int, max_mask_len: int):
    n, m, _ = data.shape
    dev = data.device
    utt = torch.randint(0, n, (batch,), generator=gen, device=dev)
    lens = lengths[utt]
    u = torch.rand(batch, generator=gen, device=dev)
    start = torch.minimum((u * (lens - frames + 1)).long(), lens - frames)
    t = torch.arange(frames, device=dev)
    crops = torch.stack([data[i, :, s:s + frames] for i, s in zip(utt.tolist(), start.tolist())])
    size = torch.randint(0, max_mask_len, (batch,), generator=gen, device=dev)
    u2 = torch.rand(batch, generator=gen, device=dev)
    mstart = (u2 * (frames - size)).long()
    keep = ~((t[None] >= mstart[:, None]) & (t[None] < (mstart + size)[:, None]))
    mask = keep.float()[:, None, :].expand(batch, m, frames)
    return crops, mask


def sample_batch(seed: int, step: int, banks, batch: int, frames: int,
                 max_mask_len: int) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch: side A then side B from one generator."""
    dev = banks[0][0].device
    gen = torch.Generator(device=dev).manual_seed(step_seed(seed, step))
    out = {}
    for side, (data, lengths) in zip("AB", banks):
        out[f"real_{side}"], out[f"mask_{side}"] = sample_side(gen, data, lengths, batch,
                                                               frames, max_mask_len)
    return out


def _lsgan(pred: torch.Tensor, target: float) -> torch.Tensor:
    return torch.mean((target - pred) ** 2)


def _l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


class Reference:
    """Two generators, four discriminators and both Adams, from ``weights``
    ({"G.A2B.<param>": tensor, "D.A.<param>": ...}); with no weights, the
    models alone on the meta device (to count their operations)."""

    def __init__(self, cfg: dict, weights: Optional[Dict[str, torch.Tensor]] = None,
                 device="meta"):
        self.cfg = cfg
        with torch.device("meta"):
            self.g = {k: Generator(cfg["n_mels"], cfg["residual_channels"],
                                   cfg["num_residual_blocks"]) for k in G_NAMES}
            self.d = {k: Discriminator(cfg["residual_channels"]) for k in D_NAMES}
        if weights is None:
            return
        for prefix, models in (("G", self.g), ("D", self.d)):
            for k, m in models.items():
                m.to_empty(device=device)
                m.load_state_dict({n: weights[f"{prefix}.{k}.{n}"] for n, _ in
                                   m.named_parameters()}, strict=True)
        betas = (cfg["adam_b1"], cfg["adam_b2"])
        self.g_opt = torch.optim.Adam(self.g_params(), lr=cfg["generator_lr"], betas=betas,
                                      eps=cfg["adam_eps"])
        self.d_opt = torch.optim.Adam(self.d_params(), lr=cfg["discriminator_lr"],
                                      betas=betas, eps=cfg["adam_eps"])

    def g_params(self) -> List[torch.Tensor]:
        return [p for k in G_NAMES for p in self.g[k].parameters()]

    def d_params(self) -> List[torch.Tensor]:
        return [p for k in D_NAMES for p in self.d[k].live_parameters()]

    def leaf_names(self) -> List[str]:
        g = [f"G.{k}.{n}" for k in G_NAMES for n, _ in self.g[k].named_parameters()]
        d = [f"D.{k}.{n}" for k in D_NAMES for n, _ in self.d[k].named_parameters()
             if not n.startswith("downSample4.")]
        return g + d

    def g_loss(self, b, lam_id: float):
        g, d, cfg = self.g, self.d, self.cfg
        ones = torch.ones_like(b["real_A"])
        fake_B = g["A2B"](b["real_A"], b["mask_A"])
        cycle_A = g["B2A"](fake_B, ones)
        fake_A = g["B2A"](b["real_B"], b["mask_B"])
        cycle_B = g["A2B"](fake_A, ones)
        identity_A = g["B2A"](b["real_A"], ones)
        identity_B = g["A2B"](b["real_B"], ones)
        adv = (_lsgan(d["B"](fake_B), 1.0) + _lsgan(d["A"](fake_A), 1.0)
               + _lsgan(d["B2"](cycle_B), 1.0) + _lsgan(d["A2"](cycle_A), 1.0))
        cycle = _l1(b["real_A"], cycle_A) + _l1(b["real_B"], cycle_B)
        identity = _l1(b["real_A"], identity_A) + _l1(b["real_B"], identity_B)
        total = adv + cfg["cycle_loss_lambda"] * cycle + lam_id * identity
        return total, {"g_adv_loss": adv, "g_cycle_loss": cycle, "g_identity_loss": identity}

    def d_loss(self, b):
        g, d = self.g, self.d
        ones = torch.ones_like(b["real_A"])
        with torch.no_grad():
            generated_A = g["B2A"](b["real_B"], b["mask_B"])
            generated_B = g["A2B"](b["real_A"], b["mask_A"])
            cycled_B = g["A2B"](generated_A, ones)
            cycled_A = g["B2A"](generated_B, ones)
        d_A = (_lsgan(d["A"](b["real_A"]), 1.0) + _lsgan(d["A"](generated_A), 0.0)) / 2
        d_B = (_lsgan(d["B"](b["real_B"]), 1.0) + _lsgan(d["B"](generated_B), 0.0)) / 2
        d_A2 = (_lsgan(d["A2"](b["real_A"]), 1.0) + _lsgan(d["A2"](cycled_A), 0.0)) / 2
        d_B2 = (_lsgan(d["B2"](b["real_B"]), 1.0) + _lsgan(d["B2"](cycled_B), 0.0)) / 2
        total = (d_A + d_B) / 2 + (d_A2 + d_B2) / 2
        return total, {"d_loss_first": d_A + d_B, "d_loss_second": d_A2 + d_B2}

    def step(self, batch, lam_id: float):
        """One iteration; returns (losses, G gradients, D gradients)."""
        g_params, d_params = self.g_params(), self.d_params()
        g_loss, g_aux = self.g_loss(batch, lam_id)
        g_grads = torch.autograd.grad(g_loss, g_params)
        _apply(self.g_opt, g_params, g_grads)
        d_loss, d_aux = self.d_loss(batch)
        d_grads = torch.autograd.grad(d_loss, d_params)
        _apply(self.d_opt, d_params, d_grads)
        losses = {"g_loss": g_loss, "d_loss": d_loss, **g_aux, **d_aux}
        return {k: float(losses[k].detach()) for k in LOSSES}, list(g_grads) + list(d_grads)


def _apply(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor], grads) -> None:
    for p, gr in zip(params, grads):
        p.grad = gr
    opt.step()
    opt.zero_grad(set_to_none=True)
