#!/usr/bin/env python3
"""Time launch-shape variants of the bf16 GELU kernels on one CUDA card.

    python3 tools/port_gelu_variants.py

Builds tools/gelu_bf16_variants.cu (which includes
camradepth_tpu_torch/csrc/gelu_bf16.cu and adds entry points whose launch
shape its macros set) once per variant in build/gelu_variants/, all
builds at once. The row "design" times the kernels of csrc/gelu_bf16.cu
as the port launches them; every other row times the variant entry
points built with its macros. For each it checks both kernels bit for bit
against the plain versions on seeded normal inputs and times them (device
time, CUDA-graph replay, as chip_smoke.py times them) at every GELU shape
of a `base` 416x800 batch-8 forward (forward kernel) and batch-2 training
microbatch (VJP), summed with each shape's launches per forward or
microbatch, beside torch's one-call `F.gelu` and `aten.gelu_backward`.
Prints the card, the library times and one line per variant with its
per-shape times. Needs a card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the macros of tools/gelu_bf16_variants.cu that each variant sets; None:
# the kernels of csrc/gelu_bf16.cu
VARIANTS = {
    "design": None,
    # the first design: two vectors per thread, one wave of blocks
    "two-vectors-one-wave": {"UNROLL": 2, "WAVES": 1},
    "two-vectors": {"UNROLL": 2},
    "global-table": {"SMEM_TABLE": 0},
    "stream-loads": {"FWD_STREAM": 1, "BWD_STREAM": 1},
    "stream-loads-and-stores": {"FWD_STREAM": 2, "BWD_STREAM": 2},
}


def build(out: Path):
    """Each variant's library, built in parallel and loaded, with the
    kernels it times: (forward, VJP)."""
    from camradepth_tpu_torch.ops import _build

    out.mkdir(parents=True, exist_ok=True)
    source = ROOT / "tools" / "gelu_bf16_variants.cu"
    procs = {}
    for name, macros in VARIANTS.items():
        defines = [f"-D{k}={v}" for k, v in (macros or {}).items()]
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *defines,
             f"-I{_build.CSRC}", "-o", str(out / f"{name}.so"), str(source)],
            stderr=subprocess.PIPE, text=True)
    kernels = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        suffix = "" if VARIANTS[name] is None else "_variant"
        fwd = getattr(lib, "gelu_bf16" + suffix)
        bwd = getattr(lib, "gelu_bf16_bwd" + suffix)
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fwd.argtypes = [p, p, ll, p]
        bwd.argtypes = [p, p, p, ll, p]
        kernels[name] = (fwd, bwd)
    return kernels


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("port_gelu_variants: needs a CUDA card")
    import chip_smoke as cs
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.ops.gelu import (
        gelu_bf16_backward_reference,
        gelu_bf16_reference,
    )

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    kernels = build(ROOT / "build" / "gelu_variants")
    cfg = preset("base")
    shapes = cs.gelu_forward_shapes(cfg)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    tensors = []
    for seed, (shape, n) in enumerate(shapes):
        x8 = cs.randn(shape, 400 + seed, torch.bfloat16)
        mb = (cs.TRAIN_BATCH,) + tuple(shape[1:])
        x2 = cs.randn(mb, 900 + seed, torch.bfloat16)
        g2 = cs.randn(mb, 950 + seed, torch.bfloat16)
        tensors.append((n, x8, torch.empty_like(x8), x2, g2,
                        torch.empty_like(x2)))
    lib_f = [cs.device_ms(lambda: F.gelu(x8, approximate="tanh"))
             for _, x8, _, _, _, _ in tensors]
    lib_b = [cs.device_ms(lambda: torch.ops.aten.gelu_backward(
        g2, x2, approximate="tanh")) for _, _, _, x2, g2, _ in tensors]
    counts = [n for n, *_ in tensors]
    print("shapes (forward batch 8, VJP batch 2): " + " ".join(
        f"{tuple(s[1:])}x{n}" for s, n in shapes))
    print(f"library: F.gelu {np.dot(counts, lib_f):.4f} ms per bf16 batch-8 "
          f"forward, aten.gelu_backward {np.dot(counts, lib_b):.4f} ms per "
          f"batch-2 microbatch; per shape: forward "
          + " ".join(f"{t:.4f}" for t in lib_f) + " | VJP "
          + " ".join(f"{t:.4f}" for t in lib_b))
    for name, (fwd_k, bwd_k) in kernels.items():
        fwd = bwd = 0.0
        per_f, per_b = [], []
        ok = True
        for n, x8, y8, x2, g2, d2 in tensors:
            def f():
                fwd_k(x8.data_ptr(), y8.data_ptr(), x8.numel(), stream())

            def b():
                bwd_k(x2.data_ptr(), g2.data_ptr(), d2.data_ptr(),
                      x2.numel(), stream())
            f()
            b()
            ok &= cs.same_bits(y8, gelu_bf16_reference(x8))
            ok &= cs.same_bits(d2, gelu_bf16_backward_reference(x2, g2))
            per_f.append(cs.device_ms(f))
            per_b.append(cs.device_ms(b))
            fwd += n * per_f[-1]
            bwd += n * per_b[-1]
        print(f"{name}: forward {fwd:.4f} ms, backward {bwd:.4f} ms, "
              f"bit for bit: {bool(ok)}; per shape: forward "
              + " ".join(f"{t:.4f}" for t in per_f) + " | VJP "
              + " ".join(f"{t:.4f}" for t in per_b), flush=True)


if __name__ == "__main__":
    main()
