#!/usr/bin/env python3
"""Profile the port's bf16 `base` forward at 416x800, batch 8, for one or
more checkouts of the repository, on one CUDA card, in the order given.

    python tools/port_forward_compare.py PARENT_DIR . . PARENT_DIR

Each directory is a checkout (or `git archive`) whose camradepth_tpu_torch
is imported in a process of its own, which builds that checkout's kernels
into its own build/kernels/. Per run it prints one JSON line: the device
busy time of one forward (torch.profiler, CUDA kernels summed), the
forward's time on the host clock in a steady loop of back-to-back forwards
(no data loading, no transfers), the device's idle share (1 - busy /
steady), the kernel launches, and the device time of each of the port's
Hopper kernels by name. Weights are random (create_model's seeded init);
the input is seeded numpy noise. Needs a card; without one it exits 1.
Listing parent and change in turns (parent, change, change, parent) keeps
a drift of the card or the host from reading as a difference.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

BATCH = 8
STEADY = 20
HOPPER_KERNELS = ("scores_", "upsample_kernel", "gelu_bf16_kernel")


def one(checkout: Path) -> dict:
    sys.path.insert(0, str(checkout))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.models.camradepth import create_model

    import camradepth_tpu_torch

    assert Path(camradepth_tpu_torch.__file__).resolve().is_relative_to(
        checkout.resolve()), camradepth_tpu_torch.__file__
    cfg = preset("base").model  # compute_dtype bfloat16
    model = create_model(cfg, device="cuda")
    h, w = cfg.img_size
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (BATCH, h, w, cfg.input_channels), dtype=np.float32)).cuda()
    with torch.inference_mode():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEADY):
            model(x)
        torch.cuda.synchronize()
        steady_ms = (time.perf_counter() - t0) * 1e3 / STEADY
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    hopper = {}
    for name in HOPPER_KERNELS:
        sel = [e for e in kernels if name in e.key]
        if sel:
            hopper[name] = {
                "ms": sum(e.self_device_time_total for e in sel) / 1e3,
                "launches": sum(e.count for e in sel)}
    return {"checkout": str(checkout), "device": torch.cuda.get_device_name(0),
            "busy_ms": busy_ms, "steady_ms": steady_ms,
            "idle_share": 1.0 - busy_ms / steady_ms,
            "launches": sum(e.count for e in kernels), "hopper": hopper}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(Path(argv[1]))))
        return 0
    import torch

    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    rc = 0
    for d in argv:
        res = subprocess.run([sys.executable, __file__, "--one", d],
                             capture_output=True, text=True, timeout=900)
        print(res.stdout.strip() or res.stderr[-3000:])
        rc |= res.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
