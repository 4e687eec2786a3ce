"""Learning-rate schedules (port of ``repro.optim.schedules``), evaluated in
float32 on the host: the step is a Python int, so the rate needs no device
round trip."""
from __future__ import annotations

import numpy as np


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    f32 = np.float32

    def sched(step):
        step = f32(step)
        warm = f32(peak) * step / f32(max(warmup_steps, 1))
        frac = np.clip((step - f32(warmup_steps))
                       / f32(max(total_steps - warmup_steps, 1)),
                       f32(0), f32(1))
        cos = f32(floor) + f32(0.5) * f32(peak - floor) * (
            f32(1) + np.cos(f32(np.pi) * frac))
        return f32(warm if step < warmup_steps else cos)
    return sched
