"""The conversion path: one caller converting and decoding utterances.

Set-up builds what ``cli/test.py`` builds with ``--vocoder_ckpt``: the
published generator (``make_convert_fn``: each mel padded to a bucket of 64
frames, its length passed, H2D, the generator, D2H) and the melgan-neurips
vocoder (``models/melgan.decode_mel`` of the converted mel in the target
speaker's statistics, then D2H), loads the benchmark's seeded weights into
both, and runs every utterance of the cycle once, so that every bucket and
every decode length the window uses has run. The window is a closed loop
with one caller: each utterance starts when the previous one's waveform is
on the host, and its latency runs from its mel on the host to its waveform
on the host.

The check runs the plain reference, in float32 with TF32 off, on a sample
of the window's answers: each answer of the cycle's longest utterance, and
each other answer with a chance of one in ``keep_one_in``, drawn from the
seed before the window opens (so that a run keeps a few dozen answers, not
all of them, and its memory stays flat over the window):
the converted mel (the reference generator at the utterance's own length,
its first frames) and the waveform (the reference MelGAN on the
reference's mel), each gap the largest absolute difference over the
reference's largest magnitude.
"""

from __future__ import annotations

import contextlib
import gc
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from maskcyclegan_vc_tpu_torch.cli.test import make_convert_fn
from maskcyclegan_vc_tpu_torch.models import Generator as ProgramGenerator
from maskcyclegan_vc_tpu_torch.models.melgan import RATIOS, MelGANGenerator, decode_mel
from maskcyclegan_vc_tpu_torch.ops.melgan_stack import DILATIONS
from maskcyclegan_vc_tpu_torch.utils.device import precision_scope, resolve_device
from portbench import bounds, flops, traffic
from portbench.clock import say
from portbench.reference import precision
from portbench.reference.melgan import MelGAN
from portbench.reference.models import Generator

FAULTS = ("altered",)


def make_weights(cfg: dict, seed: int, device):
    """(generator, vocoder) parameters by name, one seeded draw each; the
    vocoder's weights at 1.5 times torch's default bound, so that a decode
    neither fades nor saturates its tanh."""
    with torch.device("meta"):
        g = Generator(cfg["n_mels"], cfg["residual_channels"], cfg["num_residual_blocks"])
        v = MelGAN(cfg["n_mels"], cfg["vocoder"])
    return (traffic.uniform_init(g, "", traffic.generator(seed, "G", device), device),
            traffic.uniform_init(v, "", traffic.generator(seed, "vocoder", device), device,
                                 weight_gain=cfg["vocoder"]["weight_gain"]))


def check_program_fits(cfg: dict, tr: dict) -> None:
    """Refuse a configuration or traffic that the program would not run as
    stated: its MelGAN's ratios and dilations are fixed, and this path runs
    it in float32."""
    voc = cfg["vocoder"]
    dilations = tuple(3 ** j for j in range(voc["n_residual_layers"]))
    if tuple(voc["ratios"]) != RATIOS or dilations != DILATIONS:
        raise ValueError(f"the program's MelGAN has ratios {RATIOS} and dilations {DILATIONS}; "
                         f"the configuration states {voc['ratios']} and {dilations}")
    if tr["dtype"] != "float32":
        raise ValueError(f"the conversion path runs in float32, not {tr['dtype']}")


def rel_gap(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


class Path:
    def __init__(self, run):
        self.run = run
        cfg, tr, dev = run.config, run.traffic, run.device
        if run.fault not in (None, *FAULTS):
            raise ValueError(f"no fault {run.fault!r} on the conversion path: {FAULTS}")
        check_program_fits(cfg, tr)
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
        voc = MelGANGenerator(cfg["n_mels"], cfg["vocoder"]["ngf"], device=dev)
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
        self.outputs: List = []
        self.count = 0
        for i in range(len(self.mels)):
            self._utterance(i)
        self.spans = {"generator": [], "vocoder": []}
        self.outputs = []
        self.count = 0

    def _utterance(self, i: int) -> float:
        """One request: mel on the host -> waveform on the host; returns its
        seconds and keeps its answer."""
        mel = self.mels[i % len(self.mels)]
        t0 = time.perf_counter()
        fake = self.convert(mel)
        if self.run.fault == "altered":
            fake[0, 0] += 1.0
        t1 = time.perf_counter()
        wav = decode_mel(self.models[1], fake[None], self.mean, self.std)[0].cpu().numpy()
        t2 = time.perf_counter()
        self.spans["generator"].append(t1 - t0)
        self.spans["vocoder"].append(t2 - t1)
        j = i % len(self.mels)
        if j == self.longest or self.draws[self.count % len(self.draws)] < 1 / self.keep_one_in:
            self.outputs.append((j, fake, wav))
        self.count += 1
        self.audio_s += wav.size / self.run.config["sample_rate"]
        self.failed += not (np.isfinite(fake).all() and np.isfinite(wav).all())
        return t2 - t0

    def window(self, seconds: float) -> Dict:
        lat, i = [], 0
        self.audio_s = 0.0
        self.failed = 0
        t0 = time.perf_counter()
        marks = [(t0, 0.0)]  # (time, audio-seconds so far) after each utterance
        while marks[-1][0] - t0 < seconds:
            lat.append(self._utterance(i))
            i += 1
            marks.append((time.perf_counter(), self.audio_s))
        window_s = marks[-1][0] - t0
        # How the rate and the tail move inside the window, beside the whole
        # window's: by thirds of its utterances.
        cuts = [len(lat) * k // 3 for k in range(4)]
        say("audio-s/s and p95 ms by thirds of the window: " + "; ".join(
            f"{r:.2f} {p:.3f}" for r, p in (
                ((marks[b][1] - marks[a][1]) / (marks[b][0] - marks[a][0]),
                 1e3 * float(np.percentile(lat[a:b], 95)))
                for a, b in zip(cuts, cuts[1:]) if b > a)))
        self.window_spans = {k: list(v) for k, v in self.spans.items()}
        return {"metrics": {"convert_audio_s_per_s": self.audio_s / window_s,
                            "convert_p95_ms": 1e3 * float(np.percentile(lat, 95))},
                "attempted": len(lat), "failed": self.failed}

    def slice(self) -> None:
        """One cycle of the loop's utterances."""
        for i in range(len(self.mels)):
            self._utterance(i)

    def layer_context(self, traced: Dict) -> SimpleNamespace:
        """What the per-layer readers read: the traced slice (one cycle),
        and the spans of the untraced window's utterances."""
        cfg, tr = self.run.config, self.run.traffic
        voc = cfg["vocoder"]
        lengths = [m.shape[1] for m in self.mels]
        work = {t: flops.conversion(cfg, t) for t in set(lengths)}
        return SimpleNamespace(
            events=traced["device"], host=traced["host"], window_s=traced["window_s"],
            units=len(lengths), spans=self.window_spans,
            flops=sum(sum(work[t].values()) for t in lengths),
            peak_flops=bounds.PEAK_FLOPS[tr["dtype"]],
            bound_s={"melgan_stack": sum(bounds.decode_bound_s(t, voc, tr["dtype"])
                                         for t in lengths)},
            launches={})

    def gather_max(self, value):
        return value

    def gather_mean(self, value):
        return value

    def free(self) -> None:
        self.models = self.convert = None
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()
        self.scope.close()

    def check(self) -> Dict[str, float]:
        """The reference on the answers the window kept."""
        cfg, dev = self.run.config, self.run.device
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        g_w, v_w = make_weights(cfg, self.run.seed, dev)
        with torch.device("meta"):
            ref_g = Generator(cfg["n_mels"], cfg["residual_channels"], cfg["num_residual_blocks"])
            ref_v = MelGAN(cfg["n_mels"], cfg["vocoder"])
        ref_g.to_empty(device=dev).load_state_dict(g_w, strict=True)
        ref_v.to_empty(device=dev).load_state_dict(v_w, strict=True)
        mean = torch.as_tensor(self.mean, device=dev)
        std = torch.as_tensor(self.std, device=dev)

        def reference(mel: np.ndarray, operands):
            x = torch.as_tensor(mel, device=dev)[None]
            with torch.no_grad(), precision.operands(operands):
                fake = ref_g(x, torch.ones_like(x))[:, :, :mel.shape[1]]
                wav = ref_v(fake * std + mean)
            return fake[0].cpu().numpy(), wav[0].cpu().numpy()

        mel_gaps, wav_gaps = {}, {}
        for j, (idx, fake, wav) in enumerate(self.outputs):
            if self.ref_operands:
                fake, wav = reference(self.mels[idx], self.ref_operands)
            want_fake, want_wav = reference(self.mels[idx], None)
            key = f"{j}:{fake.shape[1]}"
            mel_gaps[key] = rel_gap(fake, want_fake)
            wav_gaps[key] = rel_gap(wav, want_wav)
        self.detail = {"checked": len(self.outputs),
                       "mel": dict(sorted(mel_gaps.items(), key=lambda kv: -kv[1])[:3]),
                       "wav": dict(sorted(wav_gaps.items(), key=lambda kv: -kv[1])[:3])}
        return {"mel_gap": max(mel_gaps.values()), "wav_gap": max(wav_gaps.values())}

