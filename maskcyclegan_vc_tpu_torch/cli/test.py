"""Conversion CLI: convert a speaker's utterances and write mels or wavs.

Counterpart of ``maskcyclegan_vc_tpu/cli/test.py``, with its flag names and
defaults and one more, ``--device {cuda,cpu}`` (cuda by default, with no
silent fallback). It loads the generator at ``--load_epoch`` from a
checkpoint of either package (``NNNNN_state.npz``) or from a reference
``.pth.tar``, converts every source utterance at full length with a ones
mask, and writes ``{i}-converted_{src}_to_{tgt}`` and
``{i}-original_{src}_to_{tgt}``:

- as ``.wav`` through a neural vocoder with ``--vocoder_ckpt`` (the
  conversion decoded with the target speaker's statistics, the original
  with the source's), or through Griffin-Lim on the host with
  ``--griffin_lim`` (``--griffin_lim_iters``). ``--vocoder_ckpt`` takes
  either of two checkpoint families, told apart by their keys
  (``models/vocoder.load_vocoder``): a melgan-neurips generator (a
  ``state_dict`` or a pickled module; ``models/melgan.py``), or a
  jik876/hifi-gan generator checkpoint (``{"generator": state_dict}``, as
  its training writes ``g_NNNNNNNN``, weight-normed or not; any
  ``resblock`` "1" widths, V1's included; ``models/hifigan.py``, whose
  forward scales the log10 mel by ln 10);
- as ``.npy`` mels otherwise.

``--compute_mcd`` scores each conversion against the index-paired target
utterance: log-mel-DCT MCD and MSD along a DTW path, waveform MCD when a
decoder is active (the target decoded by the same decoder), and the F0
medians, printed as the JAX CLI prints them.

    python -m maskcyclegan_vc_tpu_torch.cli.test --preprocessed_data_dir DIR \\
        --ckpt_dir DIR --load_epoch N [--model_name generator_A2B] \\
        [--vocoder_ckpt FILE | --griffin_lim] [--compute_mcd] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from maskcyclegan_vc_tpu_torch.data.audio_io import write_wav
from maskcyclegan_vc_tpu_torch.data.dataset import load_speaker
from maskcyclegan_vc_tpu_torch.eval.f0 import utterance_f0
from maskcyclegan_vc_tpu_torch.eval.mcep import mcd_dtw_wav
from maskcyclegan_vc_tpu_torch.eval.metrics import mcd_dtw, mel_spectral_distance
from maskcyclegan_vc_tpu_torch.models import Generator
from maskcyclegan_vc_tpu_torch.obs import profiler
from maskcyclegan_vc_tpu_torch.utils.device import resolve_device

BUCKET = 64


def load_generator_params(ckpt_dir: str, load_epoch: int,
                          model_name: str) -> Dict[str, torch.Tensor]:
    """The generator's state_dict from an npz checkpoint or a reference
    ``.pth.tar`` in ``ckpt_dir``."""
    ours = os.path.join(ckpt_dir, f"{load_epoch:05d}_state.npz")
    if os.path.exists(ours):
        from maskcyclegan_vc_tpu_torch.io.checkpoint import load_checkpoint_subtree
        from maskcyclegan_vc_tpu_torch.io.jax_params import generator_params_from_jax

        key = {"generator_A2B": "A2B", "generator_B2A": "B2A"}[model_name]
        return generator_params_from_jax(
            load_checkpoint_subtree(ours, f"g_params/{key}"))
    ref = os.path.join(ckpt_dir, f"{load_epoch:05d}_{model_name}.pth.tar")
    if os.path.exists(ref):
        from maskcyclegan_vc_tpu_torch.io.jax_params import load_pth_tar

        return load_pth_tar(ref)[0]
    raise FileNotFoundError(f"no checkpoint for epoch {load_epoch} in {ckpt_dir}")


def make_convert_fn(gen: Generator) -> Callable[[np.ndarray], np.ndarray]:
    """Full-length conversion (ones mask) of one (M, t) mel.

    The utterance is padded to a bucket of a multiple of 64 frames and
    ``lengths`` is passed, so the padding changes nothing in the output.
    A call is a ``convert`` span holding ``convert.h2d`` (the padded mel and
    its length to the device), ``convert.generator`` and ``convert.d2h``.
    """
    device = next(gen.parameters()).device

    @torch.inference_mode()
    def convert(mel: np.ndarray) -> np.ndarray:
        with profiler.span("convert"):
            m, t = mel.shape
            with profiler.span("convert.h2d"):
                bucket = -(-t // BUCKET) * BUCKET
                x = torch.zeros((1, m, bucket), dtype=torch.float32)
                x[0, :, :t] = torch.from_numpy(np.asarray(mel, np.float32))
                x = x.to(device)
                lengths = torch.tensor([t], dtype=torch.int32, device=device)
            with profiler.span("convert.generator"):
                y = gen(x, torch.ones_like(x), lengths)
            with profiler.span("convert.d2h"):
                return y[0, :, :t].cpu().numpy()

    return convert


def convert_utterance(gen: Generator, mel: np.ndarray) -> np.ndarray:
    """One-shot convenience wrapper around ``make_convert_fn``."""
    return make_convert_fn(gen)(mel)


def layer_summary(since_ns: int) -> str:
    """The median ms an utterance of the ``utterance``, ``convert`` and
    ``decode`` spans that started after ``since_ns`` (a layer's spans of one
    utterance summed: decode runs once per wav written)."""
    per: Dict[str, Dict[int, float]] = {k: {} for k in ("utterance", "convert", "decode")}
    for sp in profiler.spans():
        if sp.name in per and sp.start_ns >= since_ns:
            per[sp.name][sp.request] = per[sp.name].get(sp.request, 0.0) + sp.seconds
    parts = [f"{k} {1e3 * float(np.median(list(v.values()))):.3f}"
             for k, v in per.items() if v]
    n = len(per["utterance"])
    return f"ms an utterance, median of {n}: " + ", ".join(parts)


def print_options(args) -> str:
    """Resolved-flag startup dump, in the reference's format."""
    lines = ["----------------- Options ---------------"]
    for k, v in sorted(vars(args).items()):
        lines.append("{:>25}: {:<30}".format(str(k), str(v)))
    lines.append("----------------- End -------------------")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--name", type=str, default="mask_cyclegan_vc")
    p.add_argument("--save_dir", type=str, default="results")
    p.add_argument("--preprocessed_data_dir", type=str, required=True)
    p.add_argument("--speaker_A_id", type=str, default="VCC2SF3")
    p.add_argument("--speaker_B_id", type=str, default="VCC2TF1")
    p.add_argument("--ckpt_dir", type=str, required=True)
    p.add_argument("--load_epoch", type=int, required=True)
    p.add_argument("--model_name", type=str, default="generator_A2B",
                   choices=["generator_A2B", "generator_B2A"])
    p.add_argument("--vocoder_ckpt", type=str, default=None,
                   help="vocoder checkpoint, melgan-neurips or jik876/hifi-gan "
                        "generator: decode wavs with it")
    p.add_argument("--sample_rate", type=int, default=22050)
    p.add_argument("--n_mels", type=int, default=80)
    p.add_argument("--residual_channels", type=int, default=256)
    p.add_argument("--compute_mcd", action="store_true",
                   help="report DTW-aligned MCD/MSD of each conversion vs the "
                        "index-paired target utterance, and the F0 medians")
    p.add_argument("--griffin_lim", action="store_true",
                   help="without --vocoder_ckpt, decode wavs by Griffin-Lim "
                        "phase retrieval instead of writing .npy mels")
    p.add_argument("--griffin_lim_iters", type=int, default=60)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return p


def make_decode_fn(args, device) -> Optional[Callable]:
    """(mel (M, T), mean, std) -> waveform (T * 256,) for the active
    decoder: MelGAN or HiFi-GAN with ``--vocoder_ckpt``, Griffin-Lim with
    ``--griffin_lim``; None writes .npy mels."""
    if args.vocoder_ckpt:
        from maskcyclegan_vc_tpu_torch.models.melgan import decode_mel
        from maskcyclegan_vc_tpu_torch.models.vocoder import load_vocoder

        vocoder = load_vocoder(args.vocoder_ckpt, device)

        def decode(mel, mean, std):
            return decode_mel(vocoder, np.asarray(mel)[None], mean, std)[0].cpu().numpy()
        return decode
    if args.griffin_lim:
        from maskcyclegan_vc_tpu_torch.data.griffin_lim import decode_mel_griffin_lim

        def decode(mel, mean, std):
            return decode_mel_griffin_lim(mel, mean, std, n_iter=args.griffin_lim_iters)
        return decode
    return None


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    print(print_options(args), flush=True)
    device = resolve_device(args.device)
    # Args snapshot next to the run outputs, as the reference writes it.
    run_dir = os.path.join(args.save_dir, args.name)
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "test_args.json"), "w") as f:
        json.dump(vars(args), f, indent=4, sort_keys=True, default=str)

    # A2B converts A's utterances; the target is B (and the reverse).
    if args.model_name == "generator_A2B":
        src_id, tgt_id = args.speaker_A_id, args.speaker_B_id
    else:
        src_id, tgt_id = args.speaker_B_id, args.speaker_A_id
    src_mels, src_mean, src_std = load_speaker(args.preprocessed_data_dir, src_id)
    tgt_mels, tgt_mean, tgt_std = load_speaker(args.preprocessed_data_dir, tgt_id)

    sd = load_generator_params(args.ckpt_dir, args.load_epoch, args.model_name)
    gen = Generator(n_mels=args.n_mels, residual_channels=args.residual_channels,
                    device=device)
    gen.load_state_dict(sd, strict=True)
    gen.eval()
    decode = make_decode_fn(args, device)

    out_dir = os.path.join(args.save_dir, args.name,
                           f"converted_audio_{args.load_epoch}")
    os.makedirs(out_dir, exist_ok=True)
    convert = make_convert_fn(gen)
    mcds, msds, mcd_wavs, f0_conv = [], [], [], []
    loop_ns = time.time_ns()
    for i, mel in enumerate(src_mels):
        with profiler.span("utterance", request=i):
            fake = convert(mel)
            paired = args.compute_mcd and i < len(tgt_mels)
            if args.compute_mcd:
                f0_conv.append(utterance_f0(fake, tgt_mean, tgt_std))
            if paired:
                # In the vocoder's scale, the denormalized log10-mel.
                fake_db = fake * tgt_std + tgt_mean
                tgt_db = tgt_mels[i] * tgt_std + tgt_mean
                m, path = mcd_dtw(fake_db, tgt_db)
                mcds.append(m)
                msds.append(mel_spectral_distance(fake_db, tgt_db, path))
            stem_c = os.path.join(out_dir, f"{i}-converted_{src_id}_to_{tgt_id}")
            stem_o = os.path.join(out_dir, f"{i}-original_{src_id}_to_{tgt_id}")
            if decode is None:
                np.save(stem_c + ".npy", fake)
                np.save(stem_o + ".npy", mel)
                continue
            # The conversion in the target's statistics, the original in the source's.
            wav_c = decode(fake, tgt_mean, tgt_std)
            write_wav(stem_c + ".wav", wav_c, args.sample_rate)
            write_wav(stem_o + ".wav", decode(mel, src_mean, src_std), args.sample_rate)
            if paired:
                # Both sides through the same decoder, so its artifacts cancel.
                tgt_wav = decode(tgt_mels[i], tgt_mean, tgt_std)
                mcd_wavs.append(mcd_dtw_wav(wav_c, tgt_wav, sr=args.sample_rate)[0])
    print(layer_summary(loop_ns))
    print(f"wrote {len(src_mels)} conversions to {out_dir}")
    if mcds:
        # log-mel-DCT cepstra: a relative metric, not the paper's MCD.
        print(f"MCD(log-mel-DCT) {np.mean(mcds):.3f} dB (n={len(mcds)}), "
              f"MSD {np.mean(msds):.3f}")
    if mcd_wavs:
        print(f"MCD(warped-cepstral, wav) {np.mean(mcd_wavs):.3f} dB "
              f"(n={len(mcd_wavs)})")
    if f0_conv:
        f0_src = float(np.median([utterance_f0(m, src_mean, src_std) for m in src_mels]))
        f0_tgt = float(np.median([utterance_f0(m, tgt_mean, tgt_std) for m in tgt_mels]))
        print(f"F0 median: source {f0_src:.1f} Hz -> converted "
              f"{float(np.median(f0_conv)):.1f} Hz (target register "
              f"{f0_tgt:.1f} Hz)")


if __name__ == "__main__":
    main()
