"""Scalar metric logging: JSONL always, TensorBoard events when the
``tensorboard`` package can be imported.

The package's own copy of ``camradepth_tpu/utils/logging.py``: every
scalar lands in ``metrics.jsonl`` of the run directory, so a headless run
keeps its record; OSErrors are tolerated as the reference tolerates them
(runner.py:260-261). The other ranks of a multi-process run write through
:class:`NullWriter`.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional


class MetricWriter:
    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self._tb = None
        try:
            from tensorboard.compat.proto.event_pb2 import Event
            from tensorboard.compat.proto.summary_pb2 import Summary
            from tensorboard.summary.writer.event_file_writer import (
                EventFileWriter,
            )

            self._tb = EventFileWriter(str(self.log_dir))
            self._Summary = Summary
            self._Event = Event
        except Exception:
            self._tb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._jsonl.closed:
            return  # after close(): dropped, as a failed write is
        try:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "time": time.time()}) + "\n")
            self._jsonl.flush()
            if self._tb is not None:
                s = self._Summary(value=[self._Summary.Value(
                    tag=tag, simple_value=float(value))])
                self._tb.add_event(self._Event(summary=s, step=int(step),
                                               wall_time=time.time()))
        except OSError:
            pass

    def scalars(self, values: Dict[str, float], step: int,
                prefix: str = "") -> None:
        for k, v in values.items():
            self.scalar(prefix + k, v, step)

    def close(self) -> None:
        try:
            self._jsonl.close()
            if self._tb is not None:
                self._tb.close()
                self._tb = None
        except OSError:
            pass


class NullWriter:
    """The metric sink of a rank other than the primary: only the primary
    writes the run directory's files."""

    def scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def scalars(self, values: Dict[str, float], step: int,
                prefix: str = "") -> None:
        pass

    def close(self) -> None:
        pass


def create_run_dir(output_dir, arch_name: str,
                   run_name: Optional[str]) -> Path:
    """Auto-indexed run directory Output/<arch>/<run>/<n>
    (runner.py:98-113)."""
    out = Path(output_dir) / arch_name
    out.mkdir(parents=True, exist_ok=True)
    base = out / (run_name or _next_index(out))
    base.mkdir(parents=True, exist_ok=True)
    run = base / _next_index(base)
    run.mkdir(parents=True, exist_ok=True)
    return run


def _next_index(path: Path) -> str:
    nums = [int(d.name) for d in path.iterdir()
            if d.is_dir() and d.name.isdigit()] or [0]
    return str(max(nums) + 1)
