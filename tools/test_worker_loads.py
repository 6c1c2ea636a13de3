#!/usr/bin/env python3
"""Each pytest-xdist worker's load in one run of the test suite: the test
files it ran, in order, with their seconds, and its total.

    python -m pytest tests/ -v -n 6 --dist loadfile --junitxml=run.xml \
        > run.log
    python tools/test_worker_loads.py run.log run.xml [PREFIX]

The worker of each test comes from the ``[gwN] ... PASSED tests/...``
lines of the verbose log, its seconds (setup, call and teardown) from the
JUnit XML. With ``--dist loadfile`` a file runs whole on one worker, and
the run's wall time is about the largest worker's total plus start-up, so
the table shows which files lie on that worker. Seconds of the files whose
names start with PREFIX (default ``test_torch_``) are summed per worker
on a line of their own.
"""

from __future__ import annotations

import collections
import re
import sys
import xml.etree.ElementTree as ET

LINE = re.compile(r"\[(gw\d+)\] \[\s*\d+%\] \w+ (tests/\S+)")


def junit_seconds(path: str) -> dict:
    """{node id: seconds} from a JUnit XML file."""
    out: dict = collections.defaultdict(float)
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname", "").split(".")
        mod = next(i for i, p in enumerate(parts) if p.startswith("test_"))
        node = "/".join(parts[:mod + 1]) + ".py::" + "::".join(
            parts[mod + 1:] + [case.get("name", "")])
        out[node] += float(case.get("time", 0.0))
    return out


def worker_files(log: str) -> dict:
    """{worker: [node ids in the order it reported them]}."""
    seen, out = set(), collections.defaultdict(list)
    with open(log, encoding="utf-8", errors="replace") as f:
        for line in f:
            m = LINE.match(line)
            if m and m.group(2) not in seen:
                seen.add(m.group(2))
                out[m.group(1)].append(m.group(2))
    return out


def main(argv) -> int:
    if len(argv) not in (3, 4):
        print(__doc__)
        return 2
    prefix = argv[3] if len(argv) == 4 else "test_torch_"
    secs = junit_seconds(argv[2])
    loads = worker_files(argv[1])
    for gw in sorted(loads, key=lambda w: int(w[2:])):
        files: dict = collections.OrderedDict()
        for node in loads[gw]:
            name = node.split("::")[0].rsplit("/", 1)[-1]
            files[name] = files.get(name, 0.0) + secs.get(node, 0.0)
        mine = sum(v for k, v in files.items() if k.startswith(prefix))
        print(f"{gw}: {sum(files.values()):.1f} s, {prefix}* {mine:.1f} s")
        print("    " + ", ".join(f"{k[:-3]} {v:.1f}" for k, v in
                                 files.items()))
    print(f"all tests: {sum(secs.values()):.1f} s of test time")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
