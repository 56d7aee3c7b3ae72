"""The run's clock: when the process started, and phase lines on stderr."""

from __future__ import annotations

import os
import sys
import time


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def say(what: str) -> None:
    """``what``, with the seconds since the process started, on stderr."""
    print(f"[portbench] {time.time() - T_START:8.3f} s  {what}", file=sys.stderr, flush=True)
