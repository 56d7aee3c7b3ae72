"""The two-sided CycleGAN training step.

Counterpart of ``maskcyclegan_vc_tpu/train/step.py``: the reference's loss
graph per iteration. The generator update comes first (6 G forwards and 4
D forwards, LSGAN on sigmoid probabilities, cycle L1 x10, identity L1 x5
until the cutoff); then the discriminator update on the *updated*
generators' fakes, computed under ``torch.no_grad()`` (the JAX package's
``stop_gradient``).

Gradients are taken with ``torch.autograd.grad`` over one side's
parameters only: the G loss runs through the discriminators but never
differentiates their weights (JAX differentiates only ``g_params`` there),
and no ``.grad`` accumulates anywhere between the two updates.

``make_update`` is the device work of one step alone: it reads nothing back
to the host and changes no host state, so a CUDA graph can capture it
(``train/graphs.py``). ``make_train_step`` wraps it with what a step does on
the host: the learning rates for the step and the step count.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from maskcyclegan_vc_tpu_torch.ops.in_gate import widened
from maskcyclegan_vc_tpu_torch.train.schedules import identity_lambda
from maskcyclegan_vc_tpu_torch.train.state import TrainConfig, TrainState

METRICS = ("g_loss", "d_loss", "identity_lambda", "g_adv_loss", "g_cycle_loss",
           "g_identity_loss", "d_loss_first", "d_loss_second")
LOGGED_METRICS = tuple(k for k in METRICS if k != "identity_lambda")


# The losses are f32 whatever the compute dtype (JAX ``step.py:30-35``);
# f64 from f64 values (``widened``).
def _lsgan(pred: torch.Tensor, target: float) -> torch.Tensor:
    return (target - widened(pred)).square().mean()


def _l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (widened(a) - widened(b)).abs().mean()


def make_loss_fns(cfg: TrainConfig, with_identity: bool = True):
    """``(g_loss_fn, d_loss_fn)``, the production loss graph, exposed so that
    tests can differentiate it directly.

    ``g_loss_fn(g, d, batch, lam_id) -> (total, aux)`` and
    ``d_loss_fn(d, fakes, batch) -> (total, aux)``, with ``g`` and ``d``
    the dicts of generator and discriminator modules.
    """
    sched = cfg.schedule
    pair = cfg.pair_forwards_resolved()

    def gen_apply(gen, x, mask):
        if cfg.remat:
            # The generator draws no random numbers, so there is no RNG
            # state to replay (and none to read inside a graph capture).
            return checkpoint(gen, x, mask, use_reentrant=False, preserve_rng_state=False)
        return gen(x, mask)

    def g_loss_fn(g, d, batch, lam_id: float):
        real_A, mask_A = batch["real_A"], batch["mask_A"]
        real_B, mask_B = batch["real_B"], batch["mask_B"]
        B = real_A.shape[0]
        ones = torch.ones_like(real_A)
        # With ``pair`` on, same-params forwards run as one batch: fake_B and
        # identity_B through A2B; fake_A, identity_A and cycle_A through B2A.
        if pair and with_identity:
            out_ab = gen_apply(g["A2B"], torch.cat([real_A, real_B]),
                               torch.cat([mask_A, ones]))
            fake_B, identity_B = out_ab[:B], out_ab[B:]
            out_ba = gen_apply(g["B2A"], torch.cat([real_B, real_A, fake_B]),
                               torch.cat([mask_B, ones, ones]))
            fake_A, identity_A, cycle_A = out_ba[:B], out_ba[B:2 * B], out_ba[2 * B:]
        elif pair:
            fake_B = gen_apply(g["A2B"], real_A, mask_A)
            out_ba = gen_apply(g["B2A"], torch.cat([real_B, fake_B]),
                               torch.cat([mask_B, ones]))
            fake_A, cycle_A = out_ba[:B], out_ba[B:]
        else:
            fake_B = gen_apply(g["A2B"], real_A, mask_A)
            fake_A = gen_apply(g["B2A"], real_B, mask_B)
            cycle_A = gen_apply(g["B2A"], fake_B, ones)
            if with_identity:
                identity_A = gen_apply(g["B2A"], real_A, ones)
                identity_B = gen_apply(g["A2B"], real_B, ones)
        cycle_B = gen_apply(g["A2B"], fake_A, ones)

        adv = (_lsgan(d["B"](fake_B), 1.0) + _lsgan(d["A"](fake_A), 1.0)
               + _lsgan(d["B2"](cycle_B), 1.0) + _lsgan(d["A2"](cycle_A), 1.0))
        cycle_loss = _l1(real_A, cycle_A) + _l1(real_B, cycle_B)
        if with_identity and lam_id > 0.0:
            identity_loss = _l1(real_A, identity_A) + _l1(real_B, identity_B)
        else:
            # Reported as 0 past the cutoff, where the term weighs nothing.
            identity_loss = torch.zeros((), device=real_A.device)
        total = adv + sched.cycle_loss_lambda * cycle_loss + lam_id * identity_loss
        return total, {"g_adv_loss": adv, "g_cycle_loss": cycle_loss,
                       "g_identity_loss": identity_loss}

    def d_loss_fn(d, fakes, batch):
        real_A, real_B = batch["real_A"], batch["real_B"]
        B = real_A.shape[0]
        if pair:
            out_A = d["A"](torch.cat([real_A, fakes["generated_A"]]))
            out_B = d["B"](torch.cat([real_B, fakes["generated_B"]]))
            out_A2 = d["A2"](torch.cat([real_A, fakes["cycled_A"]]))
            out_B2 = d["B2"](torch.cat([real_B, fakes["cycled_B"]]))
            d_real_A, d_fake_A = out_A[:B], out_A[B:]
            d_real_B, d_fake_B = out_B[:B], out_B[B:]
            d_real_A2, d_cycled_A = out_A2[:B], out_A2[B:]
            d_real_B2, d_cycled_B = out_B2[:B], out_B2[B:]
        else:
            d_real_A, d_real_B = d["A"](real_A), d["B"](real_B)
            d_real_A2, d_real_B2 = d["A2"](real_A), d["B2"](real_B)
            d_fake_A = d["A"](fakes["generated_A"])
            d_fake_B = d["B"](fakes["generated_B"])
            d_cycled_A = d["A2"](fakes["cycled_A"])
            d_cycled_B = d["B2"](fakes["cycled_B"])
        d_loss_A = (_lsgan(d_real_A, 1.0) + _lsgan(d_fake_A, 0.0)) / 2.0
        d_loss_B = (_lsgan(d_real_B, 1.0) + _lsgan(d_fake_B, 0.0)) / 2.0
        d_loss_A2 = (_lsgan(d_real_A2, 1.0) + _lsgan(d_cycled_A, 0.0)) / 2.0
        d_loss_B2 = (_lsgan(d_real_B2, 1.0) + _lsgan(d_cycled_B, 0.0)) / 2.0
        total = (d_loss_A + d_loss_B) / 2.0 + (d_loss_A2 + d_loss_B2) / 2.0
        return total, {"d_loss_first": d_loss_A + d_loss_B,
                       "d_loss_second": d_loss_A2 + d_loss_B2}

    return g_loss_fn, d_loss_fn


@torch.no_grad()
def make_fakes(cfg: TrainConfig, g, batch) -> Dict[str, torch.Tensor]:
    """The D step's inputs: the four conversions by the (updated) generators,
    without gradient."""
    real_A, mask_A = batch["real_A"], batch["mask_A"]
    real_B, mask_B = batch["real_B"], batch["mask_B"]
    B = real_A.shape[0]
    ones = torch.ones_like(real_A)
    generated_A = g["B2A"](real_B, mask_B)
    if cfg.pair_forwards_resolved():
        # generated_B and cycled_B both run A2B, and generated_B does not
        # depend on generated_A: four forwards in three calls.
        out_ab = g["A2B"](torch.cat([real_A, generated_A]), torch.cat([mask_A, ones]))
        generated_B, cycled_B = out_ab[:B], out_ab[B:]
    else:
        cycled_B = g["A2B"](generated_A, ones)
        generated_B = g["A2B"](real_A, mask_A)
    cycled_A = g["B2A"](generated_B, ones)
    return {"generated_A": generated_A, "generated_B": generated_B,
            "cycled_A": cycled_A, "cycled_B": cycled_B}


def _apply(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, gr in zip(params, grads):
        p.grad = gr
    opt.step()
    opt.zero_grad(set_to_none=True)


def make_update(cfg: TrainConfig, with_identity: bool = True, with_eval_fake: bool = False):
    """``update(state, batch, lam_id) -> metrics``: the G update, then the D
    update, at the learning rates the optimizers hold, with identity weight
    ``lam_id`` (a host float: within one variant of the trainer it is
    constant, the schedule's weight up to the cutoff and 0 after it). The
    metrics are 0-dim device tensors.

    ``with_eval_fake`` adds ``fake_B_eval``, the A->B conversion of
    ``real_A`` by the updated generator: the ``generated_B`` that the D
    update consumed, the same tensor (f32 in either compute dtype: the
    generator returns f32, as JAX's does), at no extra forward (JAX ``train/step.py:172-194, 273-275``), for an in-loop
    vocoder decode. It is not one of ``LOGGED_METRICS``."""
    g_loss_fn, d_loss_fn = make_loss_fns(cfg, with_identity)

    def update(state: TrainState, batch: Dict[str, torch.Tensor], lam_id: float):
        g_params = state.g_params()
        g_loss, g_aux = g_loss_fn(state.g, state.d, batch, lam_id)
        _apply(state.g_opt, g_params, torch.autograd.grad(g_loss, g_params))

        fakes = make_fakes(cfg, state.g, batch)
        d_params = state.d_params()
        d_loss, d_aux = d_loss_fn(state.d, fakes, batch)
        _apply(state.d_opt, d_params, torch.autograd.grad(d_loss, d_params))

        device = batch["real_A"].device
        metrics = {"g_loss": g_loss, "d_loss": d_loss,
                   "identity_lambda": torch.full((), lam_id, device=device),
                   **g_aux, **d_aux}
        if with_eval_fake:
            metrics["fake_B_eval"] = fakes["generated_B"]
        return {k: v.detach() for k, v in metrics.items()}

    return update


def make_train_step(cfg: TrainConfig, with_identity: bool = True,
                    with_eval_fake: bool = False):
    """``train_step(state, batch) -> (state, metrics)``; the state is
    updated in place. batch: {"real_A", "mask_A", "real_B", "mask_B"}, each
    (B, M, T). The metrics are 0-dim device tensors, and ``fake_B_eval``
    with ``with_eval_fake`` (``make_update``): reading them is the caller's
    choice (each read waits for the device)."""
    return as_train_step(cfg, make_update(cfg, with_identity, with_eval_fake))


def as_train_step(cfg: TrainConfig, update):
    """One step around ``update``: the schedule's learning rates and
    identity weight for the step, the update, the step count."""
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        lam_id = identity_lambda(cfg.schedule, state.step)
        state.set_learning_rates(cfg.schedule)
        metrics = update(state, batch, lam_id)
        state.step += 1
        return state, metrics

    return train_step
