#!/usr/bin/env python3
"""Replay pytest-xdist's ``--dist loadfile`` queue over one run's JUnit XML
and print when each worker would end.

    python tools/test_schedule.py run.xml [--workers 6] [--file NAME]

The queue rule is pytest-xdist 3.8's (``xdist/scheduler/loadscope.py``,
``schedule`` and ``_reschedule``; ``--loadscope-reorder``, on by default):

- one work unit per test file, queued by its number of collected tests,
  most first, ties in collection order (the files' sorted paths);
- each worker takes one unit, and then another at once if the first holds
  2 or fewer tests;
- a worker that finishes a test and has 2 or fewer tests left takes the
  next unit.

Each test lasts what the XML says it took (setup, call and teardown), in
the order the XML lists it, on the worker that runs its file. The output
is each worker's predicted end and its files with their start times, the
largest end (the suite's wall, less start-up), and the start of ``--file``
(default ``test_distill.py``, the suite's longest file). Feed it the XML
of a measured run and compare with ``tools/test_worker_loads.py``'s
per-worker totals of the same run; change a file's tests or seconds in a
copy of the XML to ask what a move would give.
"""

from __future__ import annotations

import argparse
import collections
import sys
import xml.etree.ElementTree as ET
from typing import Dict, List, NamedTuple

THRESHOLD = 2  # xdist's "node almost depleted" heuristic


def junit_files(path: str) -> Dict[str, List[float]]:
    """{test file path: each of its tests' seconds, in the XML's order},
    the files in collection order (sorted paths)."""
    files: Dict[str, List[float]] = collections.defaultdict(list)
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname", "").split(".")
        mod = next(i for i, p in enumerate(parts) if p.startswith("test_"))
        name = "/".join(parts[:mod + 1]) + ".py"
        files[name].append(float(case.get("time", 0.0)))
    return dict(sorted(files.items()))


class Run(NamedTuple):
    file: str
    start: float
    tests: int


class Worker:
    def __init__(self, name: str):
        self.name = name
        self.t = 0.0
        self.pending: collections.deque = collections.deque()
        self.runs: List[Run] = []

    def take(self, name: str, durations: List[float]) -> None:
        self.runs.append(Run(name, -1.0, len(durations)))
        self.pending.extend((name, d) for d in durations)


def simulate(files: Dict[str, List[float]], workers: int = 6
             ) -> List[Worker]:
    """The workers after the whole queue ran; each run's start is the
    worker's clock when its file's first test began."""
    queue = collections.deque(sorted(files.items(),
                                     key=lambda kv: -len(kv[1])))
    nodes = [Worker(f"gw{i}") for i in range(min(workers, len(queue)))]
    for node in nodes:
        node.take(*queue.popleft())
    for node in nodes:
        if queue and len(node.pending) <= THRESHOLD:
            node.take(*queue.popleft())
    while any(node.pending for node in nodes):
        node = min((n for n in nodes if n.pending),
                   key=lambda n: n.t + n.pending[0][1])
        name, dur = node.pending.popleft()
        for i, run in enumerate(node.runs):
            if run.file == name and run.start < 0:
                node.runs[i] = run._replace(start=node.t)
        node.t += dur
        if queue and len(node.pending) <= THRESHOLD:
            node.take(*queue.popleft())
    return nodes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("xml")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--file", default="test_distill.py",
                    help="report when this file starts")
    args = ap.parse_args(argv)
    files = junit_files(args.xml)
    nodes = simulate(files, args.workers)
    for node in sorted(nodes, key=lambda n: -n.t):
        print(f"{node.name}: ends {node.t:.1f} s")
        print("    " + ", ".join(
            f"{r.file.rsplit('/', 1)[-1][:-3]} @{r.start:.1f}"
            for r in node.runs))
    print(f"slowest worker: {max(n.t for n in nodes):.1f} s")
    for node in nodes:
        for r in node.runs:
            if r.file.endswith("/" + args.file) or r.file == args.file:
                print(f"{args.file} ({r.tests} tests) starts at "
                      f"{r.start:.1f} s on {node.name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
