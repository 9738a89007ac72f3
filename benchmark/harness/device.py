"""The card: the check that it is there, what it is, and its peaks."""
from __future__ import annotations

import os
import subprocess
import sys
import time

# NVIDIA H100 SXM data sheet, dense, at its 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def process_start_time() -> float:
    """time.time() at which this process started (to 10 ms), from
    /proc; the interpreter's own start-up is set-up too."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    hz = os.sysconf("SC_CLK_TCK")
    return time.time() - (uptime - ticks / hz)


def require_cards(chips: int):
    """The first card, or exit without a result where there are fewer
    than `chips` CUDA cards."""
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; this benchmark measures the "
              "card and prints no result without one", file=sys.stderr)
        sys.exit(2)
    if torch.cuda.device_count() < chips:
        print(f"benchmark: {torch.cuda.device_count()} CUDA device(s), the "
              f"cell needs {chips}", file=sys.stderr)
        sys.exit(2)
    return torch.device("cuda:0")


def card_info() -> dict:
    """Name, power limit and clocks from nvidia-smi (empty where it is not
    there)."""
    query = "name,power.limit,clocks.max.sm,driver_version"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return {}
    if not out:
        return {}
    fields = [s.strip() for s in out[0].split(",")]
    return dict(zip(query.split(","), fields))
