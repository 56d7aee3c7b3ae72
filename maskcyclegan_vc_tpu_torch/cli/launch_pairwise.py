"""Job-level sharding: all-speakers pairwise training across hosts.

Counterpart of ``maskcyclegan_vc_tpu/cli/launch_pairwise.py`` (the
BASELINE's config 4: all 12 VCC2018 speakers, pairwise A<->B jobs sharded
across N hosts). Each A<->B pair is an independent training run (one
MaskCycleGAN-VC model covers both directions), so the schedule is
embarrassingly parallel: this launcher deals the pairs round-robin over the
hosts and runs this host's share one after another, each job a
``maskcyclegan_vc_tpu_torch.cli.train`` process.

    python -m maskcyclegan_vc_tpu_torch.cli.launch_pairwise \\
        --preprocessed_data_dir ... --speaker_ids VCC2SF1 VCC2SF2 ... \\
        --host_index 0 --num_hosts 4 -- --num_epochs 500 --batch_size 8

Everything after ``--`` is forwarded to the train CLI for every job. A job
that fails stops the launcher (``CalledProcessError``).
"""

from __future__ import annotations

import argparse
import itertools
import subprocess
import sys


def pair_jobs(speaker_ids):
    """Unordered pairs: one job trains both A2B and B2A."""
    return list(itertools.combinations(sorted(speaker_ids), 2))


def shard_for_host(jobs, host_index: int, num_hosts: int):
    return jobs[host_index::num_hosts]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = []
    if "--" in argv:
        i = argv.index("--")
        argv, extra = argv[:i], argv[i + 1:]

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preprocessed_data_dir", type=str, required=True)
    p.add_argument("--speaker_ids", nargs="+", required=True)
    p.add_argument("--host_index", type=int, default=0)
    p.add_argument("--num_hosts", type=int, default=1)
    p.add_argument("--save_dir", type=str, default="results")
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)

    jobs = shard_for_host(pair_jobs(args.speaker_ids),
                          args.host_index, args.num_hosts)
    print(f"host {args.host_index}/{args.num_hosts}: {len(jobs)} pair jobs")
    for a, b in jobs:
        cmd = [
            sys.executable, "-m", "maskcyclegan_vc_tpu_torch.cli.train",
            "--name", f"mask_cyclegan_vc_{a}_{b}",
            "--save_dir", args.save_dir,
            "--preprocessed_data_dir", args.preprocessed_data_dir,
            "--speaker_A_id", a, "--speaker_B_id", b,
            *extra,
        ]
        print(" ".join(cmd), flush=True)
        if not args.dry_run:
            subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
