#!/usr/bin/env python3
"""chip_smoke.py's phases (n), spatial parallel and mesh serving, and (o),
spatially sharded training, over NCCL with one rank per card, on a
machine with more than one card.

    python3 tools/port_spatial_nccl.py [--ranks 2,4] [--phases n,o]

For each rank count (default: 2, and 4 where four cards are present) it
builds the kernels, makes (n)'s references on card 0 (the fp32 golden
forward, a bf16 batch-8 engine, a 32-frame 416x800 synthetic corpus and
single-process `cli serve` maps) and runs (n): (n1) the fp32 golden
forward with the image's rows sharded over the ranks against the
golden's limits and the single-process forward, (n2) a bf16 batch-8
engine on them (launches, each kernel on its shard shapes against its
plain version, single-frame latency), (n4) HTTP on rank 0, and (n3) `cli
serve --spatial-parallel N` and `--data-parallel N` on the corpus against
the single-process maps. Then (o) at sp = 2, the one sp that trains:
(o1) the fp32 sp step of `base` at 416x800 with remat off and on against
the single-process step, a bf16 sp microbatch whose every kernel call is
held to its plain version, and the profiled bf16 sp step; (o2) `cli
train --spatial-parallel 2` and (o3) `cli distill --spatial-parallel 2`.
Prints chip_smoke's (n) and (o) lines; exits non-zero when a check
fails. On one card chip_smoke itself runs (n) and (o) on two ranks over
gloo (NCCL refuses two ranks on one card).
"""

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", default=None,
                   help="comma list of rank counts of (n) (default 2, and "
                        "4 with four cards); (o) runs on 2")
    p.add_argument("--phases", default="n,o",
                   help="comma list of the phases to run (n, o)")
    args = p.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        sys.exit("port_spatial_nccl: CUDA is not available")
    cards = torch.cuda.device_count()
    worlds = ([int(v) for v in args.ranks.split(",")] if args.ranks
              else [n for n in (2, 4) if n <= cards])
    if not worlds or max(worlds) > cards:
        sys.exit(f"port_spatial_nccl: {cards} card(s); NCCL needs one card "
                 f"per rank (asked for {worlds or [2]})")
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    if "n" in phases:
        chip_smoke.phase_n_alone(worlds=tuple(worlds))
    if "o" in phases:
        chip_smoke.phase_o_alone(worlds=(2,))
    return 0


if __name__ == "__main__":
    sys.exit(main())
