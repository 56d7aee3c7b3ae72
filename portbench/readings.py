"""The readings that the limits of a cell's check are set from.

    python3 portbench/readings.py --workload <name> --first <seed> --seeds <n>
        [--control 1 | --fault <name>] [--seconds <s>]

Runs the cell on seeds first .. first + n - 1 in one process (one a card
for a cell on several cards), each seed through ``run.execute`` as a
measured run goes, with a short window of ``--seconds``, and prints one
JSON line a seed: ``correct``, every number the check computed, and the
leaves or answers that read worst. ``--control 1`` reads the cell's
control in the program's place (the program at the next lower precision,
or the reference computed in it); ``--fault`` reads a fault planted in the
program. Not run by the benchmark's own runs.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402

from portbench.run import Run, execute, start, stop  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--first", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--rehearse_cpu", action="store_true")
    args = p.parse_args(argv)
    ranks = start(args, __file__, sys.argv[1:] if argv is None else list(argv))
    if ranks is None:
        return 2
    try:
        for seed in range(args.first, args.first + args.seeds):
            run = Run(ranks.cell, seed, ranks.device, args.rank, ranks.world,
                      control=bool(args.control), fault=args.fault)
            result = execute(run, args.seconds)
            if args.rank == 0:
                print(json.dumps({"seed": seed, "control": args.control, "fault": args.fault,
                                  "correct": result["correct"], "numbers": run.numbers,
                                  "detail": run.detail}), flush=True)
    finally:
        failed = stop(ranks)
    return failed


if __name__ == "__main__":
    sys.exit(main())
