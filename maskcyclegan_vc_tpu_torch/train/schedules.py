"""Learning-rate and loss-weight schedules as plain functions of the step.

Counterpart of ``maskcyclegan_vc_tpu/train/schedules.py``, on Python ints
and floats. The reference counts ``global_step`` in *samples* (it grows by
batch_size per iteration); here every schedule is a function of the
optimizer step count, so a resumed run continues its decay exactly.

After iteration j (0-based) the reference's global_step is (j+1)*batch; it
decays when global_step > decay_after, i.e. for all j >= floor(decay_after
/ batch), so iteration i runs with n(i) = max(0, i - floor(decay_after /
batch)) decays applied. The identity loss is off from the iteration after
global_step first exceeds stop_identity_after: lambda(i) = 0 iff
i > floor(stop_identity_after / batch).

``ref_compat_lr`` reproduces the reference's learning-rate bug: once decay
starts the generator's lr follows the *discriminator's* decaying schedule,
and the discriminator's is never decayed.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    generator_lr: float = 2e-4
    discriminator_lr: float = 1e-4
    decay_after: int = 200_000  # in samples (reference semantics)
    stop_identity_after: int = 10_000  # in samples
    num_epochs: int = 6172
    n_samples: int = 81
    batch_size: int = 1
    identity_loss_lambda: float = 5.0
    cycle_loss_lambda: float = 10.0
    ref_compat_lr: bool = False

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.n_samples // self.batch_size)

    @property
    def total_steps(self) -> int:
        return self.num_epochs * self.steps_per_epoch

    @property
    def generator_lr_decay(self) -> float:
        return self.generator_lr / float(self.total_steps)

    @property
    def discriminator_lr_decay(self) -> float:
        return self.discriminator_lr / float(self.total_steps)


def _n_decays(cfg: ScheduleConfig, step: int) -> int:
    return max(0, step - cfg.decay_after // cfg.batch_size)


def generator_lr(cfg: ScheduleConfig, step: int) -> float:
    n = _n_decays(cfg, step)
    if cfg.ref_compat_lr:
        if n == 0:
            return cfg.generator_lr
        return max(0.0, cfg.discriminator_lr - cfg.discriminator_lr_decay * n)
    return max(0.0, cfg.generator_lr - cfg.generator_lr_decay * n)


def discriminator_lr(cfg: ScheduleConfig, step: int) -> float:
    if cfg.ref_compat_lr:
        return cfg.discriminator_lr
    return max(0.0, cfg.discriminator_lr - cfg.discriminator_lr_decay * _n_decays(cfg, step))


def identity_lambda(cfg: ScheduleConfig, step: int) -> float:
    return 0.0 if step > cfg.stop_identity_after // cfg.batch_size else cfg.identity_loss_lambda
