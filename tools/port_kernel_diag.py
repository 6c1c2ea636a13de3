#!/usr/bin/env python3
"""Where the port's bf16 attention, bicubic and fused-conv kernels spend
their time, on one CUDA card (a diagnostic beside chip_smoke.py's timings).

    python3 tools/port_kernel_diag.py [attention] [bicubic] [conv]

With no argument every section runs.

Attention, at each encoder stage of `base` 416x800, batch 8: the mean time
of a launch through the Python wrapper (CUDA events around 50 back-to-back
calls, as chip_smoke.py times), of the bare C entry point called in a loop
(no wrapper), and of the bare launches replayed from a CUDA graph (device
time alone). Fused conv, at the three 416x800 ShortResBlock shapes: the
chained sources (affine + GELU on all but the first) against the same
shapes read as they are (no transform), and one plain source of the same
K. Bicubic, at the five decoder inputs of `base` 416x800, batch 8: the
kernel's device time replayed from a CUDA graph, and its rate of the bytes
it must move (one read, four writes) against 3.35 TB/s, beside the same
for a `y.copy_(x)` of as many bytes (a yardstick of the card's streaming
rate; the port never calls it). Prints one line per measurement; needs a
card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
B = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published


def events_ms(fn, iters=50):
    fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def graph_ms(fn, iters=50):
    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        with torch.cuda.graph(g, stream=stream):
            for _ in range(iters):
                fn()
    g.replay()
    torch.cuda.synchronize()
    return events_ms(g.replay, 5) / iters


def randn(shape, seed):
    g = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(g).to("cuda", torch.bfloat16)


def attention():
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.ops import _build
    from camradepth_tpu_torch.ops.attention import maxpool_attention_scores

    m = preset("base").model
    lib = _build.library("maxpool_attention_scores")
    for i in range(4):
        fh, fw = m.feature_shape(i)
        n, mm = fh * fw, (fh // m.sr_ratios[i]) * (fw // m.sr_ratios[i])
        c, heads = m.dims[i], m.heads[i]
        q, k = randn((B, n, c), i), randn((B, mm, c), 10 + i)
        out = torch.empty((B, n), device="cuda")
        scale = (c // heads) ** -0.5
        stream = torch.cuda.current_stream().cuda_stream

        def bare():
            lib.maxpool_attention_scores_bf16(
                q.data_ptr(), k.data_ptr(), out.data_ptr(), B, n, mm, c,
                heads, scale, torch.cuda.current_stream().cuda_stream)

        t_w = events_ms(lambda: maxpool_attention_scores(q, k, heads, scale))
        t_b = events_ms(bare)
        t_g = graph_ms(bare)
        del stream
        print(f"attention stage {i + 1} N={n} M={mm} C={c} h={heads}: "
              f"wrapper_ms={t_w:.4f} bare_ms={t_b:.4f} graph_ms={t_g:.4f}")


def bicubic():
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.ops.resize import upsample_bicubic_x2

    m = preset("base").model
    h, w = m.img_size
    shapes = [(*m.feature_shape(3), m.dims[3]),
              (*m.feature_shape(2), m.mid_channels),
              (*m.feature_shape(1), m.mid_channels),
              (*m.feature_shape(0), m.mid_channels + 1),
              (h // 2, w // 2, m.mid_channels + 1)]
    total = copy_total = 0.0
    for i, (hh, ww, c) in enumerate(shapes):
        x = randn((B, hh, ww, c), 20 + i)
        moved = 5 * x.numel() * x.element_size()  # one read, four writes
        t_k = graph_ms(lambda: upsample_bicubic_x2(x), 20)
        src = torch.empty(5 * x.numel() // 2, dtype=x.dtype, device="cuda")
        dst = torch.empty_like(src)
        t_c = graph_ms(lambda: dst.copy_(src), 20)
        total, copy_total = total + t_k, copy_total + t_c
        bound = moved / HBM_BYTES_PER_S * 1e3
        print(f"bicubic bf16 B={B} {hh}x{ww}x{c}: kernel_ms={t_k:.4f} "
              f"{moved / t_k / 1e6:.0f} GB/s ({100 * bound / t_k:.1f} % of "
              f"3350); copy of the same bytes copy_ms={t_c:.4f} "
              f"{moved / t_c / 1e6:.0f} GB/s; bound_ms={bound:.4f}")
        del x, src, dst
    print(f"bicubic per bf16 batch-{B} forward: kernel_ms={total:.4f} "
          f"copy_ms={copy_total:.4f}")


def conv():
    from camradepth_tpu_torch.ops.conv_fused import Source, conv3x3_fused

    h, w = 416, 800
    rng = np.random.default_rng(0)
    x0 = randn((B, h, w, 136), 1)
    r1 = randn((B, h, w, 96), 2)
    r2 = randn((B, h, w, 64), 3)

    def aff(c, seed):
        r = np.random.default_rng(seed)
        sc = torch.from_numpy((1 + 0.1 * r.standard_normal((B, c)))
                              .astype(np.float32)).cuda()
        sh = torch.from_numpy((0.1 * r.standard_normal((B, c)))
                              .astype(np.float32)).cuda()
        return sc, sh

    for srcs_plain, n in (([x0], 96), ([x0, r1], 64), ([x0, r1, r2], 128)):
        k = sum(s.shape[-1] for s in srcs_plain)
        wt = torch.from_numpy((rng.standard_normal((3, 3, k, n))
                               / np.sqrt(9 * k)).astype(np.float32)).to(
            "cuda", torch.bfloat16)
        chained = [Source(srcs_plain[0])] + [
            Source(s, *aff(s.shape[-1], j), True)
            for j, s in enumerate(srcs_plain[1:])]
        plain = [Source(s) for s in srcs_plain]
        one = [Source(randn((B, h, w, k), 9))]
        for name, srcs in (("chained", chained), ("no_transform", plain),
                           ("one_source", one)):
            t = events_ms(lambda: conv3x3_fused(srcs, wt), 5)
            print(f"conv 416x800 K={k} N={n} {name}: kernel_ms={t:.4f}")


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sections = {"attention": attention, "bicubic": bicubic, "conv": conv}
    with torch.inference_mode():
        for name in sys.argv[1:] or sections:
            sections[name]()


if __name__ == "__main__":
    main()
