"""The OneCycle learning-rate schedule.

Counterpart of ``camradepth_tpu/train/schedule.py:20-48``, which matches
``torch.optim.lr_scheduler.OneCycleLR`` as the reference configures it
(runner.py:151-152): cosine annealing in both phases, ``pct_start`` 0.15,
initial = max / ``div_factor``, min = initial / ``final_div_factor``, no
third phase. Phase 1 ends at pct_start * total_steps - 1 and phase 2 at
total_steps - 1, so the last step takes min_lr exactly. The schedule is a
function of the optimizer step count, evaluated before each step (the
first step takes lr(0)).
"""

from __future__ import annotations

import math
from typing import Callable


def onecycle(
    max_lr: float,
    total_steps: int,
    pct_start: float = 0.15,
    div_factor: float = 2.0,
    final_div_factor: float = 1e4,
) -> Callable[[int], float]:
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    phase1_end = float(pct_start * total_steps) - 1.0
    phase2_end = float(total_steps) - 1.0

    def anneal_cos(start, end, pct):
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    def schedule(count: int) -> float:
        step = float(count)
        if step <= phase1_end:
            pct = min(max(step / max(phase1_end, 1e-8), 0.0), 1.0)
            return anneal_cos(initial_lr, max_lr, pct)
        pct = min(max((step - phase1_end)
                      / max(phase2_end - phase1_end, 1e-8), 0.0), 1.0)
        return anneal_cos(max_lr, min_lr, pct)

    return schedule
