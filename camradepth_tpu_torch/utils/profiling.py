"""Tracing and profiling utilities.

Counterpart of ``camradepth_tpu/utils/profiling.py``:

- :func:`trace` records a ``torch.profiler`` trace (host operators, and
  the card's kernels where CUDA is there) and writes it as a Chrome trace
  (``chrome://tracing``, Perfetto). Unlike the JAX package's, which drops
  the trace when the backend refuses to profile, it raises when the
  profiler cannot start: a run asked to trace does not go on without one.
- :class:`StepTimer` gives steady-state step statistics; it synchronises
  the step's device before it stops the clock, since a CUDA call returns
  before the card has finished its work.
- :func:`flops_estimate` counts the FLOPs of one call with
  ``torch.utils.flop_counter.FlopCounterMode`` (the matmul-class operators
  it knows; a multiply-add counts 2).
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the block and write ``log_dir/trace_<pid>.json`` (Chrome
    trace format). A no-op when disabled; raises when the profiler cannot
    start."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}.json"))


class StepTimer:
    """Steady-state step timing that waits for the device."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._count = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None):
        """Call with a tensor of the step's outputs: on a card the clock
        stops once its device has finished the step."""
        if isinstance(sync_value, torch.Tensor) and sync_value.is_cuda:
            torch.cuda.synchronize(sync_value.device)
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"steps": 0}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps_per_sec": float(1.0 / arr.mean()),
        }


def flops_estimate(fn: Callable, *args) -> Optional[float]:
    """FLOPs of one ``fn(*args)`` call, counted by ``FlopCounterMode``
    (None when it counted no operator it knows)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    total = counter.get_total_flops()
    return float(total) if total else None
