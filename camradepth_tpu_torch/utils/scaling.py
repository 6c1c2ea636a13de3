"""Analytic multi-card scaling projection (data-parallel training).

Counterpart of ``camradepth_tpu/utils/scaling.py``, for H100s joined by
NVLink. Per optimizer step, data-parallel training overlaps

  T_compute(N) -- the forward and backward math, which shrinks with more
      cards at a fixed GLOBAL batch (strong scaling) or stays the same at
      a fixed PER-CARD batch (weak scaling), and
  T_comm(N)    -- the gradient all-reduce, ``2 * grad_bytes * (N-1)/N``
      over the per-card bandwidth (a ring: reduce-scatter plus all-gather,
      each moving (N-1)/N of the gradient out of every card).

DDP overlaps the all-reduce with the tail of the backward pass, so the
projected step time is ``max(T_compute, T_comm)`` (an optimistic bound)
and the no-overlap bound is their sum; a run lands between them. Every
number here is a PROJECTION anchored on one measured single-card step
time; nothing in it is measured at N > 1.

H100 SXM5 NVLink: 900 GB/s per card is NVIDIA's data-sheet figure, the
sum of both directions over its 18 links. A ring all-reduce sends and
receives at once, so each direction carries half of it: 450 GB/s one way,
the figure used here. Links across hosts are not modelled.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

H100_NVLINK_BW = 450e9       # bytes/s one way per card (900 GB/s both ways)
GRAD_BYTES_PER_PARAM = 4     # fp32 gradient all-reduce


@dataclass
class ScalingPoint:
    n_chips: int
    t_compute_s: float
    t_comm_s: float

    @property
    def t_overlap_s(self) -> float:          # optimistic (full overlap)
        return max(self.t_compute_s, self.t_comm_s)

    @property
    def t_serial_s(self) -> float:           # pessimistic (no overlap)
        return self.t_compute_s + self.t_comm_s

    @property
    def efficiency(self) -> float:
        """Fraction of linear speedup retained (overlapped model)."""
        return self.t_compute_s / self.t_overlap_s


def project_dp_scaling(
    param_count: int,
    step_time_1chip_s: float,
    n_chips: Sequence[int] = (1, 2, 4, 8, 16, 32),
    mode: str = "weak",
    axis_bw: float = H100_NVLINK_BW,
) -> List[ScalingPoint]:
    """Project data-parallel step times from one measured single-card
    step.

    mode="weak": per-card batch fixed (the global batch grows with N):
        T_compute stays the measured step time.
    mode="strong": global batch fixed: T_compute = measured / N (a best
        case; it ignores what a smaller per-card batch costs).
    """
    if mode not in ("weak", "strong"):
        raise ValueError(f"mode must be weak|strong, got {mode!r}")
    grad_bytes = float(param_count) * GRAD_BYTES_PER_PARAM
    points = []
    for n in n_chips:
        if n < 1:
            raise ValueError("n_chips must be >= 1")
        t_compute = (
            step_time_1chip_s if mode == "weak" else step_time_1chip_s / n
        )
        t_comm = (
            0.0 if n == 1 else 2.0 * grad_bytes * (n - 1) / n / axis_bw
        )
        points.append(ScalingPoint(n, t_compute, t_comm))
    return points


def format_projection(
    points: List[ScalingPoint],
    mode: str,
    param_count: int,
    frames_per_step: Optional[int] = None,
) -> str:
    """Human-readable table; every number labeled as a projection."""
    head = (
        f"data-parallel {mode}-scaling PROJECTION "
        f"({param_count / 1e6:.1f}M params, fp32 grads, "
        f"NVLink {H100_NVLINK_BW / 1e9:.0f} GB/s per card one way; "
        "overlap = max(compute, all-reduce), serial = sum; "
        "measured only at N=1)"
    )
    lines = [head,
             f"{'cards':>5} {'compute ms':>11} {'all-reduce ms':>13} "
             f"{'step ms (overlap..serial)':>26} {'eff':>5}"
             + ("  fps" if frames_per_step else "")]
    for p in points:
        fps = ""
        if frames_per_step:
            per_step = frames_per_step * (
                p.n_chips if mode == "weak" else 1
            )
            fps = f"  {per_step / p.t_overlap_s:.0f}"
        lines.append(
            f"{p.n_chips:>5} {p.t_compute_s * 1e3:>11.1f} "
            f"{p.t_comm_s * 1e3:>13.2f} "
            f"{p.t_overlap_s * 1e3:>12.1f}..{p.t_serial_s * 1e3:<12.1f} "
            f"{p.efficiency:>5.0%}{fps}"
        )
    return "\n".join(lines)
