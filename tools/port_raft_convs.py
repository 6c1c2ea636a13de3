#!/usr/bin/env python3
"""Time RAFT-large's update-block convolutions on the card, one by one.

    python3 tools/port_raft_convs.py

At 1/8 of 904x1600 (113x200), fp32 with TF32 off, as the prep runs RAFT:
each convolution of ``models/raft.BasicUpdateBlock`` through its module
(``PaddedConv2d`` where the model has one), then the two padded ones as
plain ``nn.Conv2d`` calls, and a 3x3 conv from 256 channels to several
output counts. Prints one line per case: ms per call (mean of 5 after a
warm-up), with the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from camradepth_tpu_torch.models import raft  # noqa: E402

HW = (113, 200)


def ms(fn, n: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / n


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("port_raft_convs: CUDA is not available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    block = raft.RAFT().update_block.cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for name, conv in block.named_modules():
            if not isinstance(conv, torch.nn.Conv2d):
                continue
            x = torch.randn(1, conv.in_channels, *HW, device="cuda",
                            generator=gen)
            kind = type(conv).__name__
            print(f"{name:18s} {kind:12s} {conv.in_channels:4d} -> "
                  f"{conv.out_channels:4d} {tuple(conv.kernel_size)}: "
                  f"{ms(lambda: conv(x)):9.3f} ms")
            if isinstance(conv, raft.PaddedConv2d):
                plain = lambda: F.conv2d(x, conv.weight, conv.bias,
                                         conv.stride, conv.padding)
                print(f"{name:18s} {'Conv2d':12s} {conv.in_channels:4d} -> "
                      f"{conv.out_channels:4d} {tuple(conv.kernel_size)}: "
                      f"{ms(plain):9.3f} ms")
        x = torch.randn(1, 256, *HW, device="cuda", generator=gen)
        for cout in (64, 126, 128, 192, 256, 384, 512):
            w = torch.randn(cout, 256, 3, 3, device="cuda", generator=gen)
            print(f"3x3 conv 256 -> {cout:4d}: "
                  f"{ms(lambda: F.conv2d(x, w, padding=1)):9.3f} ms")


if __name__ == "__main__":
    main()
