"""The conversion path with HiFi-GAN as its vocoder: one caller converting
and decoding utterances.

What ``paths/convert.py`` runs, with the vocoder of ``cli/test.py
--vocoder_ckpt`` a jik876/hifi-gan generator: set-up builds the published
generator (``make_convert_fn``) and ``models/hifigan.HiFiGANGenerator`` at
the configuration's ``hifigan`` widths, loads the benchmark's seeded weights
into both, and runs every utterance of the cycle once. Each utterance is
converted, then decoded by ``models/melgan.decode_mel`` (the log10 mel in
the target speaker's statistics; the HiFi-GAN's forward multiplies it by
ln 10), then its waveform is read back. The
window, the slice and the sample of answers kept for the check mean what
they mean in ``paths/convert.py``, whose loop this path runs.

The check runs the plain reference (``reference/models.Generator`` and
``reference/hifigan.HiFiGAN``), in float32 with TF32 off, on the kept
answers: the converted mel at the utterance's own length, and the waveform
of the reference's mel, each gap the largest absolute difference over the
reference's largest magnitude.

The traced slice's vocoder device time (``vocoder_device_s``): the device
events that start between a ``decode`` span's start and the next
``convert`` span's start, on the trace's clock (``portbench/spans.py``).
The generator's output is on the host before a decode starts and the
waveform is on the host before the next conversion starts, so those events
are the decode's own: the mel's copy in, the vocoder's kernels, the
waveform's copy out.
"""

from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from maskcyclegan_vc_tpu_torch.cli.test import make_convert_fn
from maskcyclegan_vc_tpu_torch.models import Generator as ProgramGenerator
from maskcyclegan_vc_tpu_torch.models.hifigan import HiFiGANGenerator
from maskcyclegan_vc_tpu_torch.utils.device import precision_scope, resolve_device
from portbench import bounds, hifigan_work, spans, traffic
from portbench.clock import say
from portbench.paths import convert
from portbench.reference import precision
from portbench.reference.hifigan import HiFiGAN
from portbench.reference.models import Generator

FAULTS = convert.FAULTS
# The published model takes natural-log mels; the port's are log10.
LN10 = math.log(10.0)


def make_weights(cfg: dict, seed: int, device):
    """(generator, vocoder) parameters by name, one seeded draw each (the
    generator's as ``paths/convert.py`` draws it); the vocoder's weights at
    ``weight_gain`` times torch's default bound."""
    with torch.device("meta"):
        g = Generator(cfg["n_mels"], cfg["residual_channels"], cfg["num_residual_blocks"])
        v = HiFiGAN(cfg["n_mels"], cfg["hifigan"])
    return (traffic.uniform_init(g, "", traffic.generator(seed, "G", device), device),
            traffic.uniform_init(v, "", traffic.generator(seed, "vocoder", device), device,
                                 weight_gain=cfg["hifigan"]["weight_gain"]))


def vocoder_device_s(ctx) -> Optional[float]:
    """Device seconds of the slice's decodes (the module's docstring), or
    None where the spans do not align with the trace."""
    waits = spans.waits(ctx, "convert")
    if waits is None:
        return None
    from maskcyclegan_vc_tpu_torch.obs import profiler

    base = waits["base_s"] * 10 ** 9
    lo = min(min(t for _, t, _ in ctx.host), min(t for _, t, _ in ctx.events))
    hi = max(max(t + d for _, t, d in ctx.host), max(t + d for _, t, d in ctx.events))
    sliced = spans.slice_spans([sp for sp in profiler.spans() if sp.end_ns is not None],
                               base, lo, hi)
    decodes = sorted(s for n, s, _ in sliced if n == "decode")
    converts = sorted(s for n, s, _ in sliced if n == "convert")
    if len(decodes) != ctx.units:
        return None
    took = 0.0
    for start in decodes:
        end = next((c for c in converts if c > start), math.inf)
        took += sum(d for _, t, d in ctx.events if start <= t < end)
    return took / 1e6


class Path(convert.Path):
    def __init__(self, run):
        self.run = run
        cfg, tr, dev = run.config, run.traffic, run.device
        if run.fault not in (None, *FAULTS):
            raise ValueError(f"no fault {run.fault!r} on the conversion path: {FAULTS}")
        if tr["dtype"] != "float32":
            raise ValueError(f"the conversion path runs in float32, not {tr['dtype']}")
        control = run.spec["control"] if run.control else {}
        self.ref_operands = control.get("reference_operands")
        self.keep_one_in = tr["keep_one_in"]
        self.audio_s, self.failed = 0.0, 0
        self.scope = contextlib.ExitStack()
        resolve_device(dev.type)
        self.scope.enter_context(precision_scope(control.get("program_precision",
                                                             tr["precision"])))
        g_w, v_w = make_weights(cfg, run.seed, dev)
        gen = ProgramGenerator(cfg["n_mels"], cfg["residual_channels"],
                               cfg["num_residual_blocks"], device=dev)
        gen.load_state_dict(g_w, strict=True)
        voc = HiFiGANGenerator(cfg["n_mels"], cfg["hifigan"], device=dev)
        voc.load_state_dict(v_w, strict=True)
        del g_w, v_w
        self.models = (gen.eval(), voc.eval())
        self.mean, self.std = traffic.speaker_stats(cfg["n_mels"], run.seed, dev)
        self.mels = traffic.utterances(tr, cfg["n_mels"], run.seed, dev)
        self.convert = make_convert_fn(gen)
        say("models, weights and utterances ready")
        self.longest = max(range(len(self.mels)), key=lambda j: self.mels[j].shape[1])
        self.draws = torch.rand(1 << 16, generator=traffic.generator(run.seed, "sample", "cpu"))
        self.spans = {"generator": [], "vocoder": []}
        self.outputs = []
        self.count = 0
        for i in range(len(self.mels)):
            self._utterance(i)
        self.spans = {"generator": [], "vocoder": []}
        self.outputs = []
        self.count = 0

    def layer_context(self, traced: Dict) -> SimpleNamespace:
        """What the per-layer readers read: the traced slice (one cycle), the
        spans of the untraced window's utterances, the reference's
        operations and the slice's vocoder device time."""
        cfg, tr = self.run.config, self.run.traffic
        lengths = [m.shape[1] for m in self.mels]
        work = {t: hifigan_work.conversion(cfg, t) for t in set(lengths)}
        ctx = SimpleNamespace(
            events=traced["device"], host=traced["host"], window_s=traced["window_s"],
            units=len(lengths), spans=self.window_spans,
            flops=sum(sum(work[t].values()) for t in lengths),
            vocoder_flops=sum(work[t]["vocoder"] for t in lengths),
            peak_flops=bounds.PEAK_FLOPS[tr["dtype"]], bound_s={}, launches={})
        ctx.vocoder_device_s = vocoder_device_s(ctx)
        return ctx

    def check(self) -> Dict[str, float]:
        """The reference on the answers the window kept."""
        cfg, dev = self.run.config, self.run.device
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        g_w, v_w = make_weights(cfg, self.run.seed, dev)
        with torch.device("meta"):
            ref_g = Generator(cfg["n_mels"], cfg["residual_channels"], cfg["num_residual_blocks"])
            ref_v = HiFiGAN(cfg["n_mels"], cfg["hifigan"])
        ref_g.to_empty(device=dev).load_state_dict(g_w, strict=True)
        ref_v.to_empty(device=dev).load_state_dict(v_w, strict=True)
        mean = torch.as_tensor(self.mean, device=dev)
        std = torch.as_tensor(self.std, device=dev)

        def reference(mel: np.ndarray, operands):
            x = torch.as_tensor(mel, device=dev)[None]
            with torch.no_grad(), precision.operands(operands):
                fake = ref_g(x, torch.ones_like(x))[:, :, :mel.shape[1]]
                wav = ref_v((fake * std + mean) * LN10)
            return fake[0].cpu().numpy(), wav[0].cpu().numpy()

        mel_gaps, wav_gaps = {}, {}
        for j, (idx, fake, wav) in enumerate(self.outputs):
            if self.ref_operands:
                fake, wav = reference(self.mels[idx], self.ref_operands)
            want_fake, want_wav = reference(self.mels[idx], None)
            key = f"{j}:{fake.shape[1]}"
            mel_gaps[key] = convert.rel_gap(fake, want_fake)
            wav_gaps[key] = convert.rel_gap(wav, want_wav)
        self.detail = {"checked": len(self.outputs),
                       "mel": dict(sorted(mel_gaps.items(), key=lambda kv: -kv[1])[:3]),
                       "wav": dict(sorted(wav_gaps.items(), key=lambda kv: -kv[1])[:3])}
        return {"mel_gap": max(mel_gaps.values()), "wav_gap": max(wav_gaps.values())}
