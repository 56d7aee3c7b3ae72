"""Conversion CLI: convert a speaker's utterances with one trained generator.

Counterpart of ``maskcyclegan_vc_tpu/cli/test.py``, with its flag names and
defaults and one more, ``--device {cuda,cpu}`` (cuda by default, with no
silent fallback). It loads the generator at ``--load_epoch`` from a
checkpoint of either package (``NNNNN_state.npz``) or from a reference
``.pth.tar``, converts every source utterance at full length with a ones
mask, and writes ``{i}-converted_{src}_to_{tgt}.npy`` and
``{i}-original_{src}_to_{tgt}.npy`` mels. Waveform decoding
(``--vocoder_ckpt``, ``--griffin_lim``) and ``--compute_mcd`` are not
ported yet, and argparse rejects them.

    python -m maskcyclegan_vc_tpu_torch.cli.test --preprocessed_data_dir DIR \\
        --ckpt_dir DIR --load_epoch N [--model_name generator_A2B] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict

import numpy as np
import torch

from maskcyclegan_vc_tpu_torch.data.dataset import load_speaker
from maskcyclegan_vc_tpu_torch.models import Generator
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
    """
    device = next(gen.parameters()).device

    @torch.inference_mode()
    def convert(mel: np.ndarray) -> np.ndarray:
        m, t = mel.shape
        bucket = -(-t // BUCKET) * BUCKET
        x = torch.zeros((1, m, bucket), dtype=torch.float32)
        x[0, :, :t] = torch.from_numpy(np.asarray(mel, np.float32))
        x = x.to(device)
        y = gen(x, torch.ones_like(x),
                torch.tensor([t], dtype=torch.int32, device=device))
        return y[0, :, :t].cpu().numpy()

    return convert


def convert_utterance(gen: Generator, mel: np.ndarray) -> np.ndarray:
    """One-shot convenience wrapper around ``make_convert_fn``."""
    return make_convert_fn(gen)(mel)


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
    p.add_argument("--sample_rate", type=int, default=22050)
    p.add_argument("--n_mels", type=int, default=80)
    p.add_argument("--residual_channels", type=int, default=256)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return p


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
    src_mels, _, _ = load_speaker(args.preprocessed_data_dir, src_id)

    sd = load_generator_params(args.ckpt_dir, args.load_epoch, args.model_name)
    gen = Generator(n_mels=args.n_mels, residual_channels=args.residual_channels,
                    device=device)
    gen.load_state_dict(sd, strict=True)
    gen.eval()

    out_dir = os.path.join(args.save_dir, args.name,
                           f"converted_audio_{args.load_epoch}")
    os.makedirs(out_dir, exist_ok=True)
    convert = make_convert_fn(gen)
    for i, mel in enumerate(src_mels):
        fake = convert(mel)
        np.save(os.path.join(out_dir, f"{i}-converted_{src_id}_to_{tgt_id}.npy"), fake)
        np.save(os.path.join(out_dir, f"{i}-original_{src_id}_to_{tgt_id}.npy"), mel)
    print(f"wrote {len(src_mels)} conversions to {out_dir}")


if __name__ == "__main__":
    main()
