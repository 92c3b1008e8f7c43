"""The card a run measures, and the run's fixed thread count.

Each run fixes torch's and OpenMP's thread count before it imports torch,
and logs the cores it may use and the card's name, clocks and power limit
as ``nvidia-smi`` reads them.
"""

from __future__ import annotations

import os
import subprocess

THREADS = 4          # torch's intra-op threads, and OpenMP's


def smi(fields: str) -> list[str] | None:
    """One card's ``nvidia-smi --query-gpu`` fields, or None without it."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0 or not out.stdout.strip():
        return None
    return [x.strip() for x in out.stdout.splitlines()[0].split(",")]


def steady() -> dict:
    """Fix the thread count (before torch is imported); returns it and this
    process's cores, for the run's log."""
    os.environ["OMP_NUM_THREADS"] = str(THREADS)
    return {"threads": THREADS, "cpus": sorted(os.sched_getaffinity(0))}


def readings() -> dict:
    """The card's name, clocks and power limit as nvidia-smi reads them."""
    fields = "name,clocks.sm,clocks.mem,clocks.max.sm,power.limit,power.draw,temperature.gpu"
    vals = smi(fields)
    return dict(zip(fields.split(","), vals)) if vals else {}
