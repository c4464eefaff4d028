"""Learning-rate schedules, ported from ``repro/optim/schedule.py``.

The JAX schedule maps a step array to a float32 array; here the step is a
host int and the rate is computed in float32 on the host, so the update
needs no device value for it."""
from __future__ import annotations

import numpy as np


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    def fn(step: int) -> float:
        s = np.float32(step)
        if s < warmup:
            return float(np.float32(peak) * s / np.float32(max(warmup, 1)))
        frac = np.clip((s - np.float32(warmup)) / np.float32(max(total - warmup, 1)),
                       np.float32(0), np.float32(1))
        cos = (np.float32(floor * peak) + np.float32((1 - floor) * peak) * np.float32(0.5)
               * (np.float32(1) + np.cos(np.float32(np.pi) * frac)))
        return float(cos)
    return fn
