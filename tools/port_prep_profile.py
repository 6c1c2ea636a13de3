#!/usr/bin/env python3
"""Where the offline prep's estimators spend their time on the card, at
the prep's frame size.

    python3 tools/port_prep_profile.py [--hw 416,800]

RAFT-large (20 iterations) on a pair and the Panoptic-DeepLab classmap on
a frame (padded to the reference's odd size), fp32 with TF32 off, as
chip_smoke (r) runs them, on seeded random weights (chip_smoke's
``q_synth_state``): for each, ms per call (mean of 3 after a warm-up),
then one profiled call: its device busy time (the sum of its kernels'
device time), its kernel launches and the six kernels with the most
device time. Then RAFT's parts alone, ms per call: both feature encoders,
the context encoder, the correlation pyramid, one refinement iteration
(lookup and update block) and the convex upsampling. The card's name and
power limit come first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from camradepth_tpu_torch.models import panoptic_deeplab as pdl  # noqa: E402
from camradepth_tpu_torch.models import raft  # noqa: E402


def ms(fn, n: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / n


def profiled(name: str, fn) -> None:
    wall = ms(fn)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = cs.device_kernels(prof)
    busy = sum(k.self_device_time_total for k in kernels) / 1e3
    launches = sum(k.count for k in kernels)
    print(f"{name}: {wall:.2f} ms per call, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f} %), {launches} kernel launches")
    for k in kernels[:6]:
        print(f"    {k.self_device_time_total / 1e3:8.2f} ms {k.count:5d}x "
              f"{k.key[:100]}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("port_prep_profile: CUDA is not available")
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", default="416,800")
    h, w = (int(v) for v in ap.parse_args().hw.split(","))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    im1 = cs.q_textured(h, w, 41)
    im2 = np.roll(im1, (3, -5), axis=(0, 1))
    model = raft.load_official_state_dict(
        raft.RAFT(iters=20), cs.q_synth_state(raft.RAFT(), 40)).cuda().eval()
    a = torch.from_numpy(im1[None]).cuda()
    b = torch.from_numpy(im2[None]).cuda()
    with torch.no_grad():
        profiled(f"RAFT-large {h}x{w}, 20 iterations", lambda: model(a, b))
        x1 = 2.0 * (a.permute(0, 3, 1, 2).float() / 255.0) - 1.0
        x2 = 2.0 * (b.permute(0, 3, 1, 2).float() / 255.0) - 1.0
        f1, f2 = model.fnet(x1), model.fnet(x2)
        pyr = raft.corr_pyramid(f1, f2, model.corr_levels)
        c = model.cnet(x1)
        net, inp = torch.tanh(c[:, :128]), torch.relu(c[:, 128:])
        flow = f1.new_zeros((1, 2) + tuple(f1.shape[2:]))

        def iteration():
            corr = raft.lookup_corr(pyr, flow, model.corr_radius)
            return model.update_block(net, inp, corr, flow)

        mask = iteration()[1]
        for name, fn in (
                ("fnet, both frames", lambda: (model.fnet(x1),
                                               model.fnet(x2))),
                ("cnet", lambda: model.cnet(x1)),
                ("corr_pyramid", lambda: raft.corr_pyramid(
                    f1, f2, model.corr_levels)),
                ("one iteration (lookup + update block)", iteration),
                ("lookup_corr alone", lambda: raft.lookup_corr(
                    pyr, flow, model.corr_radius)),
                ("convex_upsample", lambda: raft.convex_upsample(flow,
                                                                 mask))):
            print(f"  RAFT {name}: {ms(fn):.2f} ms")
    del model, pyr
    torch.cuda.empty_cache()
    seg = pdl.PanopticDeepLab()
    seg.load_state_dict(cs.q_synth_state(seg, 42))
    est = pdl.classmap_fn(seg, device="cuda")
    im = cs.q_textured(h, w, 43)
    ph, pw = pdl._pad_hw(h, w)
    profiled(f"Panoptic-DeepLab classmap {h}x{w} (padded to {ph}x{pw})",
             lambda: est(im))


if __name__ == "__main__":
    main()
