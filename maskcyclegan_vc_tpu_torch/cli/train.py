"""Train CLI: both generators and all four discriminators, as the reference.

Counterpart of ``maskcyclegan_vc_tpu/cli/train.py``, with its flag names
and defaults, plus ``--device {cuda,cpu}`` (cuda by default, with no silent
fallback). It writes the JAX trainer's checkpoint
(``<save_dir>/<name>/ckpts/NNNNN_state.npz``), which either package resumes
from or converts with.

    python -m maskcyclegan_vc_tpu_torch.cli.train \\
        --name mask_cyclegan_vc_VCC2SF3_VCC2TF1 --seed 0 --save_dir results/ \\
        --preprocessed_data_dir vcc2018_preprocessed/vcc2018_training \\
        --speaker_A_id VCC2SF3 --speaker_B_id VCC2TF1 \\
        --num_epochs 6172 --batch_size 1 --num_frames 64 --max_mask_len 25 \\
        --decay_after 200000 --epochs_per_save 100 --epochs_per_plot 10

Every epoch runs through one loop (``train/graphs.py``), whose losses are
read from the device once, at the epoch's end, and only then logged, at the
``--steps_per_print`` cadence. ``--scan_epochs`` is its only switch: ``1``
(the default, as in the JAX CLI) makes the step a CUDA graph on the card,
replayed once per step; ``0`` issues every step eagerly from the host. Both
run the same Adam, the capturable one on the card.

``--dtype bfloat16`` trains in bf16: convolutions in bf16, the norm kernels'
bf16 forms (f32 statistics), losses, parameters, Adam and checkpoints in
f32; ``auto`` is float32, as the JAX CLI's is off a TPU. ``--precision``
``high``, ``tensorfloat32`` or ``default`` allows TF32 in cuDNN and cuBLAS;
unset, ``highest`` or ``float32`` keep true f32. ``--fused_norms 0`` runs the
norm kernels' plain PyTorch versions on the card (``auto`` and ``1``: the
kernels).

``--distributed`` trains data parallel, one process per card, launched by
torchrun (NCCL on the card, gloo with ``--device cpu``)::

    torchrun --nproc_per_node 8 -m maskcyclegan_vc_tpu_torch.cli.train \
        --distributed --batch_size 8 ... [--grad_allreduce_dtype bfloat16]

Each process trains on its rows of the global ``--batch_size``, and each
side's gradients are averaged over the processes before its update
(``parallel/mesh.py``), on a wire of ``--grad_allreduce_dtype``; only rank
0 writes. Without torchrun's environment the run is a single process.

At plot cadence the four spectrogram panels are also decoded to audio
(``--plot_audio auto``): by the MelGAN vocoder of ``--vocoder_ckpt``, else
by Griffin-Lim.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from maskcyclegan_vc_tpu_torch.cli.test import print_options
from maskcyclegan_vc_tpu_torch.parallel.dist import finalize, initialize
from maskcyclegan_vc_tpu_torch.train.trainer import Trainer, TrainerArgs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    d = TrainerArgs()
    p.add_argument("--name", type=str, default=d.name)
    p.add_argument("--save_dir", type=str, default=d.save_dir)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--speaker_A_id", type=str, default=d.speaker_A_id)
    p.add_argument("--speaker_B_id", type=str, default=d.speaker_B_id)
    p.add_argument("--preprocessed_data_dir", type=str, default=d.preprocessed_data_dir)
    p.add_argument("--num_epochs", type=int, default=d.num_epochs)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--num_frames", type=int, default=d.num_frames)
    p.add_argument("--num_frames_validation", type=int, default=320,
                   help="accepted for the reference CLI's sake and ignored: "
                        "validation converts whole utterances, as the "
                        "reference's does")
    p.add_argument("--max_mask_len", type=int, default=d.max_mask_len)
    p.add_argument("--generator_lr", type=float, default=d.generator_lr)
    p.add_argument("--discriminator_lr", type=float, default=d.discriminator_lr)
    p.add_argument("--decay_after", type=float, default=d.decay_after)
    p.add_argument("--stop_identity_after", type=float, default=d.stop_identity_after)
    p.add_argument("--cycle_loss_lambda", type=float, default=d.cycle_loss_lambda)
    p.add_argument("--identity_loss_lambda", type=float, default=d.identity_loss_lambda)
    p.add_argument("--epochs_per_save", type=int, default=d.epochs_per_save)
    p.add_argument("--epochs_per_plot", type=int, default=d.epochs_per_plot)
    p.add_argument("--steps_per_print", type=int, default=d.steps_per_print)
    p.add_argument("--max_ckpts", type=int, default=d.max_ckpts)
    p.add_argument("--continue_train", action="store_true")
    p.add_argument("--ref_compat_lr", action="store_true",
                   help="reproduce the reference's learning-rate decay bug")
    p.add_argument("--n_mels", type=int, default=d.n_mels)
    p.add_argument("--residual_channels", type=int, default=d.residual_channels)
    p.add_argument("--remat", action="store_true",
                   help="recompute each generator forward of the G step in its "
                        "backward (less memory, more work)")
    p.add_argument("--sample_rate", type=int, default=d.sample_rate)
    p.add_argument("--async_save", type=int, choices=[0, 1], default=int(d.async_save),
                   help="write checkpoint files on a thread while training goes on")
    p.add_argument("--scan_epochs", type=int, choices=[0, 1], default=int(d.scan_epochs),
                   help="1 = the step as CUDA-graph replays on the card; 0 = every "
                        "step eagerly; either way an epoch's losses are read and "
                        "logged at its end")
    p.add_argument("--finite_check", choices=["off", "metrics", "params"],
                   default=d.finite_check,
                   help="metrics = raise at epoch end if any step's logged loss "
                        "is not finite; params = also check the whole state "
                        "before every checkpoint write")
    p.add_argument("--vocoder_ckpt", type=str, default=d.vocoder_ckpt,
                   help="melgan-neurips checkpoint for the audio at plot cadence")
    p.add_argument("--plot_audio", choices=["auto", "off"], default=d.plot_audio,
                   help="audio at plot cadence: auto = MelGAN with --vocoder_ckpt, "
                        "else Griffin-Lim; off = none")
    p.add_argument("--dtype", choices=["auto", "float32", "bfloat16"], default=d.dtype,
                   help="compute dtype; auto = float32")
    p.add_argument("--precision", type=str, default=d.precision,
                   help="highest/float32 (the default): true f32; "
                        "high/tensorfloat32/default: TF32 convolutions and matmuls")
    p.add_argument("--fused_norms", choices=["auto", "0", "1"], default=d.fused_norms,
                   help="the norm kernels (auto, 1) or their plain versions (0)")
    p.add_argument("--device", type=str, default=d.device, choices=["cuda", "cpu"])
    p.add_argument("--distributed", action="store_true",
                   help="join torchrun's process group (parallel/dist.py): data "
                        "parallel over its processes, NCCL on the card, gloo on the CPU")
    p.add_argument("--grad_allreduce_dtype", choices=["float32", "bfloat16"],
                   default=d.grad_allreduce_dtype or "float32",
                   help="wire dtype of the data-parallel gradient all-reduce; "
                        "bfloat16 halves the collective bytes for bandwidth-limited "
                        "links (parallel/mesh.explicit_sync_fns)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    print(print_options(args), flush=True)
    created = initialize(args.device) if args.distributed else False
    try:
        np.random.seed(args.seed)
        targs = TrainerArgs(**{f.name: getattr(args, f.name)
                               for f in dataclasses.fields(TrainerArgs)})
        targs.decay_after = int(targs.decay_after)
        targs.stop_identity_after = int(targs.stop_identity_after)
        targs.async_save = bool(targs.async_save)
        targs.scan_epochs = bool(targs.scan_epochs)
        Trainer(targs).train()
    finally:
        finalize(created)


if __name__ == "__main__":
    main()
