"""The training path: the trainer's epoch loop of CUDA-graph replays.

Set-up builds what ``train/trainer.Trainer`` builds for ``--scan_epochs
1`` (``create_train_state`` with capturable Adams, the speakers' mel banks
on the device, the data-parallel sync hooks in the process group that
``run.start`` joined, a ``StepRunner`` over the identity variant of the
update), loads the benchmark's seeded weights into it, and drives its
first three steps through ``StepRunner.run``, the window's own call: the
first runs eagerly and is captured, the next two replay. The window then calls
``StepRunner.run`` in spans of ``steps_per_epoch`` steps, each followed by
its one read of the metrics to the host, as ``Trainer._run`` does.

The check follows those three steps with the plain reference on the same
weights and batches: each step's seven logged losses, the norm of each
leaf's first gradient (from Adam's first moment after step 1: m = (1 -
b1) g), and the norm of each leaf's change after step 3.
"""

from __future__ import annotations

import contextlib
import gc
import math
import statistics
import time
from types import SimpleNamespace
from typing import Dict, List

import torch
import torch.distributed as dist

from maskcyclegan_vc_tpu_torch.data.dataset import MelBank
from maskcyclegan_vc_tpu_torch.parallel import dist as pdist
from maskcyclegan_vc_tpu_torch.parallel.mesh import explicit_sync_fns, replicate
from maskcyclegan_vc_tpu_torch.train.graphs import StepRunner
from maskcyclegan_vc_tpu_torch.train.schedules import ScheduleConfig
from maskcyclegan_vc_tpu_torch.train.state import TrainConfig, create_train_state
from maskcyclegan_vc_tpu_torch.train.step import LOGGED_METRICS, make_update
from maskcyclegan_vc_tpu_torch.utils.device import precision_scope, resolve_device
from portbench import bounds, flops, traffic
from portbench.clock import say
from portbench.reference import precision
from portbench.reference.models import Discriminator, Generator
from portbench.reference.step import D_NAMES, G_NAMES, LOSSES, Reference, sample_batch

# Leaves whose reference gradient is under this share of the median leaf's
# move by Adam's rounding alone (a conv bias ahead of an InstanceNorm):
# their change is not compared.
STILL_LEAF = 1e-3
FAULTS = ("unchanged", "half_batch", "no_exchange")


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Both generators' and all four discriminators' parameters, named
    "G.A2B.<param>" ..., one seeded draw a side."""
    with torch.device("meta"):
        g = Generator(cfg["n_mels"], cfg["residual_channels"], cfg["num_residual_blocks"])
        d = Discriminator(cfg["residual_channels"])
    out = {}
    for side, model, names in (("G", g, G_NAMES), ("D", d, D_NAMES)):
        gen = traffic.generator(seed, side, device)
        for k in names:
            out.update(traffic.uniform_init(model, f"{side}.{k}.", gen, device))
    return out


def leaf_norms(named: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(named)
    norms = torch.stack([torch.linalg.vector_norm(named[k].float()) for k in names]).cpu()
    return dict(zip(names, norms.tolist()))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves=None) -> Dict[str, float]:
    """Each leaf's |‖prog‖ - ‖ref‖| over the larger of its reference norm
    and the median leaf's."""
    med = statistics.median(ref.values())
    leaves = ref.keys() if leaves is None else leaves
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves}


def worst(gaps: Dict[str, float], n: int = 3) -> Dict[str, float]:
    return dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:n])


class Path:
    def __init__(self, run):
        self.run = run
        cfg, tr, dev = run.config, run.traffic, run.device
        if run.fault not in (None, *FAULTS):
            raise ValueError(f"no fault {run.fault!r} on the training path: {FAULTS}")
        if cfg["discriminators"] != len(D_NAMES):
            raise ValueError(f"the program trains {len(D_NAMES)} discriminators, "
                             f"not {cfg['discriminators']}")
        control = run.spec["control"] if run.control else {}
        self.ref_operands = control.get("reference_operands")
        self.scope = contextlib.ExitStack()
        resolve_device(dev.type)
        self.scope.enter_context(precision_scope(control.get("program_precision",
                                                             tr["precision"])))
        self.batch = tr["batch"] * run.world  # the global batch
        lr = 0.0 if run.fault == "unchanged" else 1.0
        sched = ScheduleConfig(
            generator_lr=lr * cfg["generator_lr"], discriminator_lr=lr * cfg["discriminator_lr"],
            decay_after=cfg["decay_after"], stop_identity_after=cfg["stop_identity_after"],
            num_epochs=cfg["num_epochs"], n_samples=tr["utterances"], batch_size=self.batch,
            identity_loss_lambda=cfg["identity_loss_lambda"],
            cycle_loss_lambda=cfg["cycle_loss_lambda"])
        self.tcfg = TrainConfig(
            schedule=sched, n_mels=cfg["n_mels"], num_frames=tr["frames"],
            residual_channels=cfg["residual_channels"], adam_b1=cfg["adam_b1"],
            adam_b2=cfg["adam_b2"], adam_eps=cfg["adam_eps"],
            dtype=torch.bfloat16 if tr["dtype"] == "bfloat16" else None,
            precision=control.get("program_precision", tr["precision"]), fused_norms=True)
        self.steps_per_epoch = sched.steps_per_epoch
        self.cutoff = cfg["stop_identity_after"] // self.batch

        self.state = create_train_state(self.tcfg, run.seed, dev, capturable=dev.type == "cuda")
        say("train state created")
        weights = make_weights(cfg, run.seed, dev)
        for side, models in (("G", self.state.g), ("D", self.state.d)):
            for k, m in models.items():
                m.load_state_dict({n: weights[f"{side}.{k}.{n}"] for n, _ in m.named_parameters()})
        del weights
        banks = [MelBank(data, lengths) for data, lengths in
                 traffic.speakers(tr, cfg["n_mels"], run.seed, dev)]
        sync, rows = {}, slice(None)
        if run.world > 1:
            replicate(self.state)
            rows = pdist.local_batch_slice(self.batch)
            if run.fault != "no_exchange":
                grad_sync, metric_sync = explicit_sync_fns(tr.get("wire"))
                sync = {"grad_sync": grad_sync, "metric_sync": metric_sync}
        if run.fault == "half_batch":
            rows = slice(0, self.batch // 2)
        self._updates = {}

        def update_for(step: int):
            wi = step <= self.cutoff
            if wi not in self._updates:
                self._updates[wi] = make_update(self.tcfg, with_identity=wi, **sync)
            return self._updates[wi]

        self.runner = StepRunner(self.tcfg, update_for, *banks, run.seed, self.batch,
                                 tr["frames"], cfg["max_mask_len"], rows=rows)
        self.leaves = self._leaves()
        say("weights, speakers and runner ready")
        # The first three steps, through the window's own call.
        first = self.runner.run(self.state, 1).cpu()
        b1 = self.tcfg.adam_b1
        self.grad = leaf_norms({k: opt.state[p]["exp_avg"] / (1 - b1)
                                for k, (opt, p) in self.leaves.items()})
        say("step 1 run and captured")
        rest = self.runner.run(self.state, 2).cpu()
        self.losses = [dict(zip(LOGGED_METRICS, r)) for r in torch.cat([first, rest]).tolist()]
        w0 = make_weights(cfg, run.seed, dev)
        self.change = leaf_norms({k: p.detach() - w0[k] for k, (_, p) in self.leaves.items()})
        del w0
        self._sync()

    def _leaves(self):
        """{leaf name: (its optimizer, the parameter)} in the optimizers' order."""
        s = self.state
        out = {f"G.{k}.{n}": (s.g_opt, p) for k in G_NAMES for n, p in s.g[k].named_parameters()}
        out.update({f"D.{k}.{n}": (s.d_opt, p) for k in D_NAMES
                    for n, p in s.d[k].named_parameters() if not n.startswith("downSample4.")})
        return out

    def _sync(self):
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def _agree(self, go: bool) -> bool:
        """Rank 0's decision, on every rank."""
        if self.run.world == 1:
            return go
        flag = torch.tensor([int(go)], device=self.run.device)
        dist.broadcast(flag, 0)
        return bool(flag.item())

    def _span(self) -> int:
        """One epoch's span of steps and its one read; returns the steps
        whose losses are not all finite."""
        n = self.steps_per_epoch
        if self.state.step + n > self.cutoff + 1:
            raise RuntimeError(f"step {self.state.step + n} passes the identity cutoff "
                               f"{self.cutoff}: a second graph would be captured")
        vals = self.runner.run(self.state, n).cpu()
        return int((~torch.isfinite(vals).all(dim=1)).sum())

    def window(self, seconds: float) -> Dict:
        tr, cfg = self.run.traffic, self.run.config
        steps = failed = 0
        ends = [time.perf_counter()]
        while True:
            failed += self._span()
            steps += self.steps_per_epoch
            ends.append(time.perf_counter())
            if not self._agree(ends[-1] - ends[0] < seconds):
                break
        window_s = ends[-1] - ends[0]
        # How the steps' time spreads inside the window, beside the rate.
        per_step = sorted(1e3 * (b - a) / self.steps_per_epoch for a, b in zip(ends, ends[1:]))
        say(f"{len(per_step)} spans of {self.steps_per_epoch} steps, ms a step: least "
            f"{per_step[0]:.3f}, median {statistics.median(per_step):.3f}, most "
            f"{per_step[-1]:.3f}")
        audio_s = steps * self.batch * tr["frames"] * cfg["hop"] / cfg["sample_rate"]
        return {"metrics": {"train_audio_s_per_s": audio_s / window_s},
                "attempted": steps, "failed": failed}

    def slice_steps(self) -> int:
        n = self.steps_per_epoch
        return n * math.ceil(self.run.traffic["trace_steps"] / n)

    def slice(self) -> None:
        for _ in range(self.slice_steps() // self.steps_per_epoch):
            self._span()

    def layer_context(self, traced: Dict) -> SimpleNamespace:
        """What the per-layer readers read, of this rank's share of the
        slice's steps."""
        cfg, tr = self.run.config, self.run.traffic
        steps, rows = self.slice_steps(), tr["batch"]
        if self.run.fault == "half_batch":
            rows = self.batch // 2
        sites = bounds.train_step_sites(rows, cfg["n_mels"], tr["frames"], cfg["residual_channels"],
                                        cfg["num_residual_blocks"], self.batch < 16)
        per_step = bounds.sites_bound_s(sites, tr["dtype"])
        launches: Dict[str, int] = {}
        for k, _ in sites:
            launches[k] = launches.get(k, 0) + steps
        return SimpleNamespace(
            events=traced["device"], host=traced["host"], window_s=traced["window_s"],
            units=steps, flops=steps * flops.train_step(cfg, rows, tr["frames"]),
            peak_flops=bounds.PEAK_FLOPS[tr["dtype"]],
            bound_s={k: v * steps for k, v in per_step.items()}, launches=launches)

    def gather_max(self, value: float):
        return self._reduce(value, dist.ReduceOp.MAX)

    def gather_mean(self, value: float):
        return self._reduce(value, dist.ReduceOp.SUM) / self.run.world

    def _reduce(self, value, op):
        if self.run.world == 1:
            return value
        t = torch.tensor([float(value)], dtype=torch.float64, device=self.run.device)
        dist.all_reduce(t, op=op)
        return int(t.item()) if isinstance(value, int) else t.item()

    def free(self) -> None:
        """Drop the program's state, graphs and banks."""
        self.runner = self.state = self.leaves = self._updates = None
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()
        self.scope.close()

    def check(self) -> Dict[str, float]:
        """The plain reference over the first three steps, and the gaps."""
        cfg, tr, dev = self.run.config, self.run.traffic, self.run.device
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        banks = traffic.speakers(tr, cfg["n_mels"], self.run.seed, dev)
        batches = [sample_batch(self.run.seed, s, banks, self.batch, tr["frames"],
                                cfg["max_mask_len"]) for s in range(3)]
        ref = self._follow(batches, None)
        prog = (self._follow(batches, self.ref_operands) if self.ref_operands else
                {"losses": self.losses, "grad": self.grad, "change": self.change})
        med = statistics.median(ref["grad"].values())
        moving = [k for k, v in ref["grad"].items() if v >= STILL_LEAF * med]
        losses = {f"{k}.{i + 1}": abs(p[k] - r[k]) / abs(r[k])
                  for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"])) for k in LOSSES}
        grad = leaf_gaps(prog["grad"], ref["grad"])
        change = leaf_gaps(prog["change"], ref["change"], moving)
        self.detail = {"loss": worst(losses), "grad": worst(grad), "change": worst(change),
                       "still_leaves": len(ref["grad"]) - len(moving)}
        return {"loss_gap": max(losses.values()),
                "loss1_gap": max(v for k, v in losses.items() if k.endswith(".1")),
                "grad_gap": max(grad.values()),
                "grad_median_gap": statistics.median(grad.values()),
                "change_gap": max(change.values()),
                "change_median_gap": statistics.median(change.values())}

    def _follow(self, batches, operands) -> Dict:
        """The reference's three steps from the seeded weights, its
        convolutions' operands rounded to ``operands`` (None: float32)."""
        cfg, dev = self.run.config, self.run.device
        w0 = make_weights(cfg, self.run.seed, dev)
        ref = Reference(cfg, w0, dev)
        losses: List[Dict[str, float]] = []
        grad = None
        with precision.operands(operands):
            for b in batches:
                step_losses, grads = ref.step(b, cfg["identity_loss_lambda"])
                losses.append(step_losses)
                if grad is None:
                    grad = leaf_norms(dict(zip(ref.leaf_names(), grads)))
        params = dict(zip(ref.leaf_names(), ref.g_params() + ref.d_params()))
        change = leaf_norms({k: p.detach() - w0[k] for k, p in params.items()})
        del ref, w0
        gc.collect()
        return {"losses": losses, "grad": grad, "change": change}
