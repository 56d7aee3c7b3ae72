#!/usr/bin/env python3
"""The cost of one span of the port's recorder (``obs/profiler.span``) on
this host: ns a span, opened and closed empty inside an enclosing span (as
the program's inner spans are), the median of ``--rounds`` rounds of
``--spans`` spans each.

    python3 scripts/span_cost.py [--spans 200000] [--rounds 7]
"""

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from maskcyclegan_vc_tpu_torch.obs import profiler  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--spans", type=int, default=200_000)
    p.add_argument("--rounds", type=int, default=7)
    args = p.parse_args()
    rounds = []
    for _ in range(args.rounds):
        with profiler.span("span_cost"):
            t0 = time.perf_counter_ns()
            for i in range(args.spans):
                with profiler.span("span_cost.inner", request=i):
                    pass
            rounds.append((time.perf_counter_ns() - t0) / args.spans)
    print(f"span_cost: {statistics.median(rounds):.1f} ns a span (median of {args.rounds} "
          f"rounds of {args.spans}; rounds {min(rounds):.1f}-{max(rounds):.1f})", flush=True)


if __name__ == "__main__":
    main()
