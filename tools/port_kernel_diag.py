#!/usr/bin/env python3
"""Where the port's bf16 attention, bicubic and fused-conv kernels and the
two backward kernels of the attention and the bicubic spend their time, on
one CUDA card (a diagnostic beside chip_smoke.py's timings).

    python3 tools/port_kernel_diag.py [attention] [bicubic] [conv]
        [adjoint] [adjoint_rows] [attention_bwd] [attention_bwd_tokens]

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
rate; the port never calls it).

The backward kernels at the shapes of a bf16 training microbatch of `base`
at 416x800 (batch 2), each through its wrapper (CUDA events around 50
calls) and replayed from a CUDA graph, summed per microbatch (the adjoint
once per decoder stage, the attention backward once per encoder block).
Adjoint: beside a `copy_` of the bytes it must move (gy read, gx written);
adjoint_rows: the bare entry point with 4, 8, 16 and 32 gx rows per block
(the plan picks one), from a CUDA graph. Attention backward: also each of
its kernels apart (device time per call from torch.profiler over 20
calls); attention_bwd_tokens: the bare entry point with 32, 64, 128 and
256 tokens per chunk (the plan picks one), from a CUDA graph. The adjoint
and attention_bwd sections take only the wrappers, so this file, copied
into an earlier checkout, times that checkout's kernels in turns with
this one's. Prints one line per measurement; needs a card.
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


TRAIN_B = 2  # a training microbatch


def decoder_inputs():
    """The five decoder inputs (H, W, C) of `base` at 416x800."""
    from camradepth_tpu_torch.config import preset

    m = preset("base").model
    h, w = m.img_size
    return [(*m.feature_shape(3), m.dims[3]),
            (*m.feature_shape(2), m.mid_channels),
            (*m.feature_shape(1), m.mid_channels),
            (*m.feature_shape(0), m.mid_channels + 1),
            (h // 2, w // 2, m.mid_channels + 1)]


def adjoint():
    from camradepth_tpu_torch.ops.resize import upsample_bicubic_x2_backward

    total = total_w = copy_total = 0.0
    for i, (hh, ww, c) in enumerate(decoder_inputs()):
        gy = randn((TRAIN_B, 2 * hh, 2 * ww, c), 30 + i)
        n_in = gy.numel() // 4
        moved = 5 * n_in * gy.element_size()  # gy read, gx written

        def fn():
            upsample_bicubic_x2_backward(gy)

        t_w = events_ms(fn)
        t_g = graph_ms(fn, 20)
        src = torch.empty(5 * n_in // 2, dtype=gy.dtype, device="cuda")
        dst = torch.empty_like(src)
        t_c = graph_ms(lambda: dst.copy_(src), 20)
        total, total_w = total + t_g, total_w + t_w
        copy_total += t_c
        bound = moved / HBM_BYTES_PER_S * 1e3
        print(f"adjoint bf16 B={TRAIN_B} gx {hh}x{ww}x{c}: wrapper_ms="
              f"{t_w:.4f} graph_ms={t_g:.4f} {moved / t_g / 1e6:.0f} GB/s "
              f"({100 * bound / t_g:.1f} % of 3350); copy of the same bytes "
              f"copy_ms={t_c:.4f} {moved / t_c / 1e6:.0f} GB/s; bound_ms="
              f"{bound:.4f}")
        del gy, src, dst
    print(f"adjoint per bf16 batch-{TRAIN_B} microbatch: graph_ms={total:.4f}"
          f" wrapper_ms={total_w:.4f} copy_ms={copy_total:.4f}")


def adjoint_rows():
    from camradepth_tpu_torch.ops.resize import (
        launch_backward,
        upsample_backward_plan,
    )

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (hh, ww, c) in enumerate(decoder_inputs()):
        gy = randn((TRAIN_B, 2 * hh, 2 * ww, c), 30 + i)
        gx = torch.empty((TRAIN_B, hh, ww, c), dtype=gy.dtype, device="cuda")
        plan = upsample_backward_plan(TRAIN_B, hh, ww, c, 2, sms)
        times = []
        for rows in (4, 8, 16, 32):
            def bare(rows=rows):
                launch_backward(gy, gx, upsample_backward_plan(
                    TRAIN_B, hh, ww, c, 2, sms, rows))
            times.append(f"rows={rows}: {graph_ms(bare, 20):.4f}")
        print(f"adjoint bf16 B={TRAIN_B} gx {hh}x{ww}x{c} graph_ms by gx rows "
              f"per block (plan: {plan.rows}): " + ", ".join(times))
        del gy, gx


def attention_bwd():
    from torch.profiler import ProfilerActivity, profile

    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.ops.attention import (
        maxpool_attention_scores_backward,
        maxpool_attention_scores_with_argmax,
    )

    m = preset("base").model
    total = total_w = 0.0
    passes = {}
    for i in range(4):
        fh, fw = m.feature_shape(i)
        n, mm = fh * fw, (fh // m.sr_ratios[i]) * (fw // m.sr_ratios[i])
        c, heads = m.dims[i], m.heads[i]
        q, k = randn((TRAIN_B, n, c), 40 + i), randn((TRAIN_B, mm, c), 50 + i)
        g = randn((TRAIN_B, n), 60 + i).float()
        scale = (c // heads) ** -0.5
        amax = maxpool_attention_scores_with_argmax(q, k, heads, scale)[1]

        def fn():
            maxpool_attention_scores_backward(q, k, amax, g, heads, scale)

        t_w = events_ms(fn)
        t_g = graph_ms(fn)
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        kern = [(e.key, e.self_device_time_total / 20e3)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        for name, ms in kern:
            passes[name] = passes.get(name, 0.0) + m.depths[i] * ms
        total, total_w = total + m.depths[i] * t_g, total_w + m.depths[i] * t_w
        print(f"attention_bwd bf16 stage {i + 1} B={TRAIN_B} N={n} M={mm} "
              f"C={c} h={heads} x{m.depths[i]}: wrapper_ms={t_w:.4f} "
              f"graph_ms={t_g:.4f}; per kernel: " + ", ".join(
                  f"{name[:40]}={ms:.4f}" for name, ms in kern))
        del q, k, g, amax
    print(f"attention_bwd per bf16 batch-{TRAIN_B} microbatch: graph_ms="
          f"{total:.4f} wrapper_ms={total_w:.4f}; per kernel (profiler): "
          + ", ".join(f"{name[:40]}={ms:.4f}" for name, ms in passes.items()))


def attention_bwd_tokens():
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.ops.attention import (
        launch_backward,
        maxpool_attention_scores_with_argmax,
        scores_backward_plan,
    )

    m = preset("base").model
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i in range(4):
        fh, fw = m.feature_shape(i)
        n, mm = fh * fw, (fh // m.sr_ratios[i]) * (fw // m.sr_ratios[i])
        c, heads = m.dims[i], m.heads[i]
        q, k = randn((TRAIN_B, n, c), 40 + i), randn((TRAIN_B, mm, c), 50 + i)
        g = randn((TRAIN_B, n), 60 + i).float()
        scale = (c // heads) ** -0.5
        amax = maxpool_attention_scores_with_argmax(q, k, heads, scale)[1]
        dq, dk = torch.empty_like(q), torch.empty_like(k)
        times = []
        for tokens in (32, 64, 128, 256):
            def bare(tokens=tokens):
                launch_backward(q, k, amax, g, dq, dk, heads, scale,
                                scores_backward_plan(TRAIN_B, n, mm, c, heads,
                                                     2, sms, tokens))
            times.append(f"tokens={tokens}: {graph_ms(bare):.4f}")
        plan = scores_backward_plan(TRAIN_B, n, mm, c, heads, 2, sms)
        print(f"attention_bwd bf16 stage {i + 1} graph_ms by tokens per "
              f"chunk (plan: {plan.tokens}): " + ", ".join(times))


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sections = {"attention": attention, "bicubic": bicubic, "conv": conv,
                "adjoint": adjoint, "adjoint_rows": adjoint_rows,
                "attention_bwd": attention_bwd,
                "attention_bwd_tokens": attention_bwd_tokens}
    with torch.inference_mode():
        for name in sys.argv[1:] or sections:
            sections[name]()


if __name__ == "__main__":
    main()
