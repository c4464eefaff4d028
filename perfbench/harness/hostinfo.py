"""The machine a run ran on: the card's name, power limit and clocks, and
the host's CPU, cores, affinity and load.  Host-paced numbers move with
the machine; this says which machine."""
from __future__ import annotations

import os
import platform
import subprocess

SMI = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def card() -> list[dict] | str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={SMI}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    keys = SMI.split(",")
    return [dict(zip(keys, (v.strip() for v in line.split(","))))
            for line in out.stdout.strip().splitlines()]


def collect() -> dict:
    return {"card": card(), "cpu": cpu_model(), "cores": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)), "loadavg": list(os.getloadavg())}
