"""Training configuration and state: two generators, four discriminators,
two Adams and the step.

Counterpart of ``maskcyclegan_vc_tpu/train/state.py``. The JAX package
keeps one immutable pytree; here the state is the modules and optimizers
themselves, updated in place by the train step. ``io.jax_params``
``train_state_to_jax`` / ``train_state_from_jax`` carry it to and from the
JAX trainer's checkpoint layout.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from maskcyclegan_vc_tpu_torch.models import Discriminator, Generator
from maskcyclegan_vc_tpu_torch.obs import profiler
from maskcyclegan_vc_tpu_torch.train.schedules import (
    ScheduleConfig,
    discriminator_lr,
    generator_lr,
)

G_NAMES = ("A2B", "B2A")
D_NAMES = ("A", "B", "A2", "B2")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Model and optimizer construction, with the JAX package's names.

    ``dtype``: the models' compute dtype (None: f32; ``torch.bfloat16``);
    parameters, Adam's moments and checkpoints stay f32 whatever it is.
    ``precision``: the convolutions' and matmuls' precision, read by
    ``utils.device.precision_scope`` (None, "highest" or "float32": true
    f32, TF32 off; "high", "tensorfloat32" or "default": TF32).
    ``fused_norms``: the port's norm kernels (True), or their plain PyTorch
    versions (False), the JAX package's XLA path. The JAX package's other
    lowering knobs (k3_matmul, split_gated_conv) have no counterpart."""

    schedule: ScheduleConfig = dataclasses.field(default_factory=ScheduleConfig)
    n_mels: int = 80
    num_frames: int = 64
    residual_channels: int = 256
    adam_b1: float = 0.5  # the reference's Adam settings
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    include_dead_params: bool = True
    dtype: Optional[torch.dtype] = None
    precision: Optional[str] = None
    fused_norms: bool = True
    remat: bool = False  # recompute each G forward of the G step in its backward
    # Batch same-params forwards (fake, identity and cycle rows through one
    # generator call; each D's real and fake pair through one call).
    # None = auto: on below 16 samples.
    pair_forwards: Optional[bool] = None

    def pair_forwards_resolved(self) -> bool:
        if self.pair_forwards is None:
            return self.schedule.batch_size < 16
        return self.pair_forwards


@dataclasses.dataclass
class TrainState:
    step: int                      # optimizer updates made; a host int
    g: Dict[str, Generator]        # {"A2B", "B2A"}
    d: Dict[str, Discriminator]    # {"A", "B", "A2", "B2"}
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam

    def g_params(self):
        return [p for name in G_NAMES for p in self.g[name].parameters()]

    def d_params(self):
        """The discriminators' live parameters: the dead block has no
        moments and is never updated, as the JAX package's masked optimizer
        leaves it."""
        return [p for name in D_NAMES for p in self.d[name].live_parameters()]

    def set_learning_rates(self, sched: ScheduleConfig) -> None:
        """Both Adams' lr for the coming update, from the schedule at the
        step count before it (optax ``scale_by_schedule``'s count). A
        capturable Adam's lr is a device tensor, written in place (a launch,
        no host synchronisation), so that a captured step reads it."""
        for opt, lr in ((self.g_opt, generator_lr(sched, self.step)),
                        (self.d_opt, discriminator_lr(sched, self.step))):
            for group in opt.param_groups:
                if isinstance(group["lr"], torch.Tensor):
                    group["lr"].fill_(lr)
                else:
                    group["lr"] = lr


def make_optimizer(cfg: TrainConfig, params, capturable: bool = False) -> torch.optim.Adam:
    """torch Adam matches optax ``scale_by_adam`` then ``-lr``: both compute
    lr * m_hat / (sqrt(v_hat) + eps) with m_hat = m / (1 - b1^t) and
    v_hat = v / (1 - b2^t), eps after the bias-corrected square root (torch
    writes it as lr/(1-b1^t) * m / (sqrt(v)/sqrt(1-b2^t) + eps)).

    ``capturable``: the form a CUDA graph can capture, for parameters on the
    card: the step count and the bias corrections stay on the device and the
    lr is a float32 device tensor (torch supports this only on devices it
    lists, the CPU not among them). The trainer's Adam form follows the
    device alone: capturable on the card, whether its steps are captured
    or run eagerly, so both run the same f32 bias corrections on the
    device; the plain form, host f64 corrections, on the CPU."""
    if not capturable:
        return torch.optim.Adam(params, lr=cfg.schedule.generator_lr,
                                betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps)
    params = list(params)
    lr = torch.tensor(cfg.schedule.generator_lr, device=params[0].device)
    return torch.optim.Adam(params, lr=lr, betas=(cfg.adam_b1, cfg.adam_b2),
                            eps=cfg.adam_eps, capturable=True)


def create_train_state(cfg: TrainConfig, seed: int = 0, device="cpu",
                       capturable: bool = False) -> TrainState:
    """Both generators and all four discriminators, torch's default init
    drawn from seeded CPU generators (seed, seed+1 for A2B, B2A; seed+2..5
    for A, B, A2, B2, as the JAX package seeds them), and both optimizers
    (``make_optimizer``'s ``capturable``); a ``train.create_state`` span."""
    device = torch.device(device)
    kw = dict(device=device, dtype=cfg.dtype, fused_norms=cfg.fused_norms)
    with profiler.span("train.create_state"):
        g = {name: Generator(cfg.n_mels, cfg.residual_channels,
                             generator=torch.Generator().manual_seed(seed + i), **kw)
             for i, name in enumerate(G_NAMES)}
        d = {name: Discriminator(cfg.residual_channels, cfg.include_dead_params,
                                 generator=torch.Generator().manual_seed(seed + 2 + i), **kw)
             for i, name in enumerate(D_NAMES)}
        state = TrainState(0, g, d, None, None)
        state.g_opt = make_optimizer(cfg, state.g_params(), capturable)
        state.d_opt = make_optimizer(cfg, state.d_params(), capturable)
    return state
