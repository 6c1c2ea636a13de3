#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (camradepth_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the port's Hopper kernels from camradepth_tpu_torch/csrc/ and runs:
  (a) the card, its power limit, the versions and the kernels' build;
  (b) each kernel against its plain PyTorch version at every shape of the
      416x800 `base` forward at batch 8, in bf16 and fp32 (the GELU kernel:
      bf16, bit for bit, also on all 65,536 bf16 inputs), plus ragged
      shapes, with kernel, plain, library
      and bound times (kernel and library: device time, replayed from a
      CUDA graph; plain: CUDA events around eager calls), and each bicubic
      launch's share of its bound;
  (c) the 416x800 `base` forward in fp32 (TF32 off) on the committed
      golden's synthesized weights, held against tests/goldens/
      flagship_416x800.npz, with 34 + 5 kernel launches per forward (and
      no GELU kernel: fp32 GELU is exact erf);
  (d) the main path: load_engine on a reference-format .pth at `base` in
      bf16, batch 8, answering 27 frames through infer_stream, held
      against the fp32 forward;
  (e) a torch.profiler breakdown of one bf16 batch-8 forward by kernel,
      with each Hopper kernel's launches and the device's idle share;
  (f) the fused 3x3 conv + GroupNorm-stats kernel: its own main path, the
      15 ShortResBlock convs of `base` at 416x800, batch 8, chained as the
      block chains them (each later layer reads the earlier raw outputs
      through their GroupNorm affine and GELU), then each of them and one
      ragged shape against the plain version in bf16 and fp32, with
      kernel, plain, library and bound times for the set of 15;
  (g) `cli test` and `cli serve` on the card at `base` 416x800, batch 8, on
      a 32-frame synthetic corpus and the golden's weights as a .pth:
      test in bf16 and in fp32, the fp32 report held against the CPU's
      over 2 frames (one sunny, one rain) and the bf16 one against the
      fp32 one, and
      serve writing 32 depth maps, with frames/s;
  (h) training: each backward kernel (attention scores with the forward's
      argmax, bicubic adjoint, bf16 GELU VJP) against its plain version at
      every shape of a `base` 416x800 batch-2 microbatch in bf16 and fp32,
      plus ragged shapes (the adjoint also where both edges' folds meet,
      the GELU VJP also on every bf16 x against a sweep of cotangents over
      every exponent field; the attention backward also where every
      token's argmax is one key, timed on its own), with kernel, plain,
      library and bound times; one
      fp32 optimizer step (TF32 off, no dropout) of `base` at 128x256 on
      the card against the port's CPU run of the same step; then the main
      path of this slice, `cli train` at `base` 416x800 in bf16, batch 2 x
      update_interval 3, one epoch of 4 optimizer steps on a 32-frame
      synthetic corpus split 24/8, with eval and a best checkpoint that
      load_engine serves, the launches of every kernel per microbatch, and
      steps/s, peak memory and one profiled step's device idle share;
  (i) the seg presets and the tpu_decoder variant: (i1) the fp32 forwards
      of sup_unsup_seg and of base + tpu_decoder at 128x256 (TF32 off)
      against tests/goldens/flagship_seg_128x256.npz and
      tpu_decoder_128x256.npz, with the JAX tests' limits; (i2) a bf16
      DepthEngine stream of sup_unsup_seg at batch 8, 416x800 (uint8
      labels, 34 attention, 7 bicubic and 59 GELU launches per forward,
      depth and labels against the fp32 forward, busy and idle shares);
      (i3) cli test --preset sup_unsup_seg, fp32 on the card against the
      CPU over 2 frames (iou included), and bf16; (i4) cli train --preset
      sup_unsup_seg as in (h), its best checkpoint serving depth and
      labels, and one profiled step; (i5) the bf16 batch-8 forward of
      base and of base + tpu_decoder in turns (3 bicubic launches per
      forward for the variant) and 2 steps of cli train --tpu-decoder;
  (j) cli distill and the compact wire format: (j1) cli distill from a
      `base` teacher (the golden's weights as a .pth) into a `base` +
      tpu_decoder student, bf16, batch 2 x 3, one epoch of 4 steps on the
      24/8 split, with the warm start's count, 34 + 34 + 34 attention,
      5 + 3 + 3 bicubic and 53 + 53 + 53 GELU launches per microbatch
      (teacher forward, student forward and backward), a best checkpoint
      that load_engine serves, and one profiled distill step; (j2) each
      wire path against its dense run: a wire batch decoded on the card
      against the dense batch bit for bit, cli test --wire on (fp32, TF32
      off) against dense cli test, rtol 1e-6 per metric, cli serve --wire
      on against dense cli serve (bf16) bit for bit, and one bf16 cli
      train --wire on step's loss against the dense step's;
  (k) the serving artifact and the HTTP front end: (k1) cli export of
      `base` bf16 batch 8 on the card (torch.export, the kernels as
      operators), a fresh load_engine on it against the live engine on
      the same frames (bit for bit expected, limit 1e-2 m; 34, 5 and 53
      launches per forward), and, in a worker process, a base +
      tpu_decoder bf16 artifact with a dynamic batch against the live
      engine at batches 3 and 8 (34, 3, 53); (k2, worker) an fp32
      artifact exported on the CPU serving on the card through the
      kernels, against the 416x800 golden; (k3, workers) cli test on that
      artifact against cli test on its checkpoint (rtol 1e-6 per metric),
      cli serve on the bf16 artifact against the checkpoint's maps, and
      --wire on with an artifact refused; then the artifact's and the live
      forward's device busy time and steady stream in turns; (k4)
      start_server on the bf16 artifact engine: 8 concurrent single-frame
      POSTs coalesce and each answer equals infer_batch of its frame bit
      for bit, requests/s and latency of 8 clients, and a wire engine over
      HTTP (data.wire_radar_cap) against the dense engine;
  (l) the loader's native host code (C++ built with g++, called through
      ctypes outside the interpreter lock), on (g)'s 32-frame 416x800
      corpus: (l1) the host's g++, machine and CPUs and the build's
      seconds, then every frame assembled and wire-encoded natively and in
      numpy, bit for bit, native by the counts; (l2) the loader alone
      (BatchLoader, batch 8, 8 workers, no model) dense and wire, numpy
      and native in turns, and one thread's ms per frame of the load, the
      assembly and the wire encode; (l3) cli test and cli serve in bf16,
      native and numpy in turns: the reports' metrics and the served maps
      equal, 34/5/53 launches per forward, frames/s;
  (m) multi-device training: (m1) at world size 1 on the card (NCCL), one
      bf16 optimizer step of base 416x800 (batch 2 x 3) single-device,
      under DDP and under FSDP2 (both built through Trainer(layout=...))
      from the same weights, microbatches and dropout generators: losses,
      grad_norm and every parameter against the single-device step
      (relative L2 1e-6), 34 + 34 / 5 + 5 / 53 + 53 launches per
      microbatch, then step wall ms, device busy and peak memory of each
      in turns; (m2) cli train --coordinator --num-processes 1 for 2 steps
      on (g)'s corpus, its checkpoint served by load_engine; (m3) beside
      (m2), on the host's CPUs with gloo, parallel/gradcheck.py's check of
      2-rank DDP, 2-rank FSDP2 and 4-rank data 2 x fsdp 2 against the
      single-process step (grad_parity, two steps with uneven valid-GT
      counts and dropout, a supervised_seg step);
  (n) spatial parallel and mesh serving, on two ranks that share the one
      card over gloo (NCCL refuses two ranks on one card), after (m3)'s
      processes end: (n1) the fp32 golden forward with the image's rows
      sharded over sp = 2 (TF32 off), the gathered maps against the
      416x800 golden's limits and within rtol 1e-4 of the single-process
      fp32 forward, 34 + 5 launches per rank, then fp32 batch-8 engines
      (load_engine on a mesh) with the frames' rows over sp and with the
      batch over data, each within the same limit of the single-process
      fp32 engine; (n2) a bf16 batch-8 engine on
      them: within the bf16 serving limit of the fp32 forward, its mean and
      max difference from the single-process bf16 engine (beside the
      single-process batch-4 engine's from the batch-8 one), 34 / 5 / 53
      launches per rank per forward, each kernel's every call on its shard
      shapes against its plain version, and the single-frame latency (two
      ranks sharing one card: not a scaling figure); (n4) 8 concurrent
      POSTs to an HTTP server on rank 0 (the other rank following it), each
      answer = infer_batch of its frame, bit for bit; (n3) cli serve
      --spatial-parallel 2 and --data-parallel 2 on (g)'s corpus against
      (g)'s single-process maps. `python3 chip_smoke.py --phase n` runs
      (a), (c) and (n) alone, with (d)'s engine and (g)'s corpus made
      again; tools/port_spatial_nccl.py runs (n) over NCCL on several
      cards;
  (o) spatially sharded training on the two ranks (`--phase o`);
  (p) hyperparameter search, the trials vmapped through the kernels:
      (p1) each of the six training launch points under torch.func.vmap
      over 4 trials at every shape of a base 416x800 batch-2 microbatch
      and a ragged one, one launch per vmapped call, against the plain
      version on the folded batch at (h)'s limits; (p2) one fp32 vmapped
      step of 3 trials (base at 128x256, TF32 off) against the port's CPU
      run and against one unvmapped torch.func step per trial on the card
      (near-tie argmax rows forced to the vmapped keys); (p3) this
      slice's main path, cli search --vmap-trials at base 416x800 bf16,
      batch 2 x 3, 4 trials x 3 steps on (g)'s corpus split 24/8, with
      34 + 34, 5 + 5, 53 + 53 launches per vmapped microbatch, then the
      vmapped step and cli train's one-trial step in turns and one
      profiled vmapped step; (p4) --vmap-trials --halving (rungs of 4 and
      2, survivors continuing); (p5) the sequential search and --halving
      through the Trainer; (p6) --vmap-trials --data-parallel 2 on two
      ranks sharing the card over gloo against one process (`--phase p`);
  (q) the prep estimators on synthesized official-key weights, fp32, TF32
      off: RAFT-large (904x1600, 20 iterations), the Panoptic-DeepLab
      classmap (900x1600, padded to 929x1601), lk_flow and
      rasterize_radar at 900x1600: finite, two runs equal, ms per frame,
      and each at a small size against the port's CPU run (`--phase q`);
  (r) the offline prep on the synthetic nuScenes world of
      tests/torch_fake_nuscenes.py (one scene of 8 samples, 900x1600
      camera jpgs, 4 frames in its split): (r1) run_pipeline's ten stages
      on the card with RAFT-large (jax-raft, 20 iterations) and
      Panoptic-DeepLab (jax-panoptic, remap cityscapes) on synthesized
      official-key weights, twice, the files bit for bit, ms per frame of
      each stage; (r2) the six host stages again on the CPU from (r1)'s
      jpgs, flow and mseg, every file = (r1)'s; (r3) cli validate-data and
      cli test --preset base --mini-dataset (bf16, the golden's weights) on
      the prepared directory, a finite report and 34 / 5 / 53 launches per
      forward; (r4) cli prep's missing-devkit and label-space answers, rc 2
      (`--phase r`);
  (s) the tools: (s1) cli bench and cli bench --train (base 416x800 bf16
      batch 8, K forwards timed by CUDA events; the train step of 6 padded
      to 8 with both remats), each one JSON line with the JAX bench's
      keys, the card's name and power limit, 34 / 5 / 53 launches per
      timed forward (tpu_decoder 34 / 3 / 53) and an attainable floor
      (utils/roofline.py) at or under the measured ms per frame; (s2) the
      roofline's kernel floors at base batch 8 against PERF.md's bound
      column; (s3) cli summary --preset base in a process that leaves
      CUDA untouched; (s4) cli viz on the golden's weights and on (k1)'s
      bf16 artifact over 4 of (g)'s frames, one forward each at 34 / 5 /
      53 launches, the same collages; (s5) cli inspect on the .pth, the
      artifact and the split; (s6) cli doctor, rc 0, naming the card
      (`--phase s`).
Any failed check raises, so the exit code is not 0. The last two lines are
the kernels' JSON record and {"ok": true, "device": {...}}. Needs a CUDA
card and nvcc; without a card it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores
BATCH = 8
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)  # dot summed in another order
# The bicubic and GELU kernels round as their plain versions do: bit for
# bit.
UPSAMPLE_TOL = dict(rtol=0.0, atol=0.0)
# the bicubic kernel's time per bf16 batch-8 forward in its earlier design
# (one thread per input element and channel, 25 scalar loads), measured as
# phase (b) measures it on an NVIDIA H100 80GB HBM3 at 700 W
UPSAMPLE_EARLIER_MS = 2.141
# the bf16 GELU kernels' times in their earlier designs (each block
# evaluating its table with tanhf; the VJP's 21 operations in full per
# element), per bf16 batch-8 forward and per batch-2 microbatch, measured
# as phases (b) and (h) measure them on an NVIDIA H100 80GB HBM3 at 700 W
GELU_EARLIER_MS = 3.188
GELU_BWD_EARLIER_MS = 2.790
# the two other backward kernels' times per bf16 batch-2 microbatch in
# their earlier designs (the adjoint: one thread per element, each axis its
# own launch through a workspace; the attention backward: three launches
# and a dense [chunks][M][C] fp32 partial), measured as phase (h) measures
# them on an NVIDIA H100 80GB HBM3 at 700 W
ADJOINT_EARLIER_MS = 1.205
ATTN_BWD_EARLIER_MS = 1.008
# bf16 serving vs the fp32 forward, mean depth error in metres (0..100 m):
# bf16 keeps 8 significant bits through 34 blocks and 5 decoder stages;
# a frame with another frame's depth is off by ~14 m.
SERVE_MEAN_ABS_M = 1.5
# Fused conv, kernel vs plain version. Both sum exact products in fp32, in
# other orders, before the one rounding of the raw output: in bf16 at most
# 1 bf16 ulp, taken at no less than 2**-7 of the output's RMS (below that
# the sums' order differences, up to ~1.5e-5 of the RMS on the H100, exceed
# a bf16 ulp); in
# fp32 the JAX package's limits (tests/test_conv_fused.py:38-40). The fp32
# channel sums run over up to 332,800 terms: rtol 1e-4, atol 1e-3*sqrt(H*W).
CONV_F32_TOL = dict(rtol=1e-4, atol=2e-5)
CONV_BF16_ULPS = 1.0
CONV_SUM_RTOL = 1e-4
# cli test on the card in fp32 vs the port's own CPU run over the same 4
# frames: two fp32 forwards (TF32 off) that sum in other orders
REPORT_RTOL = 1e-3
# the report keys of camradepth_tpu.cli test --report-json (base preset):
# the metrics, frames, and the timing keys
METRIC_KEYS = tuple(
    [f"{m}_{c}" for c in (100, 50) for m in ("mae", "rmse", "rel")]
    + [f"true_{m}_{c}" for c in (50, 70, 80) for m in ("mae", "rmse", "rel")]
    + ["rmse_edge", "rmse_sunny"])
REPORT_KEYS = METRIC_KEYS + (
    "frames", "wall_s", "time_per_frame_s", "frames_per_sec_end_to_end",
    "frames_per_sec_steady", "time_per_frame_steady_s")


def require(ok: bool, what) -> None:
    """A check that holds under ``python -O`` too (unlike assert)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn`` call: ``iters`` calls captured in a CUDA
    graph and replayed, so that the host's dispatch of a Python wrapper,
    which exceeds a small kernel's device time, is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    return ms


def bound(bytes_moved: float, ops: float, ops_per_s: float):
    """(bytes time, operations time) in ms: the least time the card could
    take is the larger of the two."""
    return bytes_moved / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3


def add_bound(r, per_fwd, t_bytes, t_ops):
    """Add one shape's bound, ``per_fwd`` times, to a kernel's record."""
    r["bound_ms"] += per_fwd * max(t_bytes, t_ops)
    r["_bytes_ms"] = r.get("_bytes_ms", 0.0) + per_fwd * t_bytes
    r["_ops_ms"] = r.get("_ops_ms", 0.0) + per_fwd * t_ops
    r["bound_by"] = ("bytes" if r["_bytes_ms"] >= r["_ops_ms"]
                     else "operations")


def same_bits(got, want) -> bool:
    """bf16 tensors equal bit for bit, any NaN matching any NaN (the
    kernels and torch write different NaN payloads)."""
    return bool(((got.view(torch.int16) == want.view(torch.int16))
                 | (got.isnan() & want.isnan())).all())


def every_bf16():
    """All 65,536 bf16 values, in the order of their bits."""
    return torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32,
                        device="cuda").to(torch.int16).view(torch.bfloat16)


def cotangent_sweep(seed=31):
    """bf16 cotangents: for each exponent field 1..254 of both signs one
    value with a seeded mantissa, plus +-0, 16 subnormals of each sign,
    +-inf and NaN."""
    rng = np.random.default_rng(seed)
    fields = np.arange(1, 255, dtype=np.uint16)
    normal = (fields << 7) | rng.integers(0, 128, fields.size).astype(
        np.uint16)
    sub = rng.integers(1, 128, 16).astype(np.uint16)
    mags = np.concatenate([normal, sub, [0, 0x7F80]]).astype(np.uint16)
    bits = np.concatenate([mags, mags | 0x8000, [0x7FC0]]).astype(np.uint16)
    return torch.from_numpy(bits.view(np.int16)).cuda().view(torch.bfloat16)


def randn(shape, seed, dtype):
    g = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(g).to(device="cuda", dtype=dtype)


def phase_a():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    from camradepth_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    print(f"(a) card: {smi} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | python {sys.version.split()[0]} | {nvcc}")
    from camradepth_tpu_torch import native

    t0 = time.perf_counter()
    # the loader's host library (g++) builds beside the kernels (nvcc)
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.library)
        libs = _build.build_all()
        host.result()
    print(f"(a) kernels built in parallel and loaded in "
          f"{time.perf_counter() - t0:.1f} s; the loader's host library "
          f"in {native.build_info['seconds']:.2f} s")
    # registers, stack (spills) and shared memory of each kernel, read
    # from the built libraries
    cuobjdump = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    for name in libs:
        usage = subprocess.run(
            [cuobjdump, "--dump-resource-usage",
             str(_build.build_dir() / f"lib{name}.so")],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.splitlines()
        for fn, res in zip(usage, usage[1:]):
            if fn.strip().startswith("Function") and "REG:" in res:
                print(f"(a) {name}: {fn.strip()} {res.strip()}")
    return smi


def phase_b(cfg):
    from camradepth_tpu_torch.ops.attention import (
        maxpool_attention_scores,
        maxpool_attention_scores_reference,
    )
    from camradepth_tpu_torch.ops.gelu import gelu_bf16, gelu_bf16_reference
    from camradepth_tpu_torch.ops.resize import (
        upsample_bicubic_x2,
        upsample_bicubic_x2_reference,
    )

    m = cfg.model
    h, w = m.img_size
    # (N, M, C, heads, launches per forward) for each encoder stage
    attn_shapes = []
    for i in range(4):
        fh, fw = m.feature_shape(i)
        sr = m.sr_ratios[i]
        attn_shapes.append(((fh * fw), (fh // sr) * (fw // sr), m.dims[i],
                            m.heads[i], m.depths[i]))
    # off the tiles: d = 40 with N and M ragged; d = 8 with N below one
    # 16-token tile; M = 1
    ragged_attn = [(1001, 77, 120, 3, 0), (9, 33, 8, 1, 0), (37, 1, 40, 1, 0)]
    # (H, W, C, launches per forward) of the five decoder-stage inputs
    mid = m.mid_channels
    up_shapes = [(*m.feature_shape(3), m.dims[3], 1),
                 (*m.feature_shape(2), mid, 1),
                 (*m.feature_shape(1), mid, 1),
                 (*m.feature_shape(0), mid + 1, 1),
                 (h // 2, w // 2, mid + 1, 1)]
    ragged_up = (7, 9, 129, 0)
    gelu_shapes = gelu_forward_shapes(cfg) + [((3, 5, 7, 13), 0)]

    rec = {
        "maxpool_attention_scores": dict(
            route="cuda",
            source="camradepth_tpu_torch/csrc/maxpool_attention_scores.cu",
            replaces="camradepth_tpu/ops/attention_pallas.py:76",
            max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
            library_ms=None, bound_by=None),
        "upsample_bicubic_x2": dict(
            route="cuda",
            source="camradepth_tpu_torch/csrc/upsample_bicubic_x2.cu",
            replaces="camradepth_tpu/ops/resize_pallas.py:209",
            max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
            library_ms=0.0, bound_by=None),
        "gelu_bf16": dict(
            route="cuda", source="camradepth_tpu_torch/csrc/gelu_bf16.cu",
            replaces="camradepth_tpu/models/layers.py:41",
            max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
            library_ms=0.0, bound_by=None),
    }
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.finfo(dtype).bits // 8
        tag = str(dtype).removeprefix("torch.")
        r = rec["maxpool_attention_scores"]
        for seed, (n, mm, c, heads, per_fwd) in enumerate(
                attn_shapes + ragged_attn):
            q = randn((BATCH, n, c), seed, dtype)
            k = randn((BATCH, mm, c), 100 + seed, dtype)
            scale = (c // heads) ** -0.5
            got = maxpool_attention_scores(q, k, heads, scale)
            want = maxpool_attention_scores_reference(q, k, heads, scale)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rel = ((got - want).abs() / want.abs().clamp_min(1e-6)).max()
            torch.testing.assert_close(got, want, **ATTN_TOL)
            t_k = device_ms(lambda: maxpool_attention_scores(q, k, heads,
                                                             scale))
            t_p = cuda_ms(lambda: maxpool_attention_scores_reference(
                q, k, heads, scale), iters=5)
            t_b, t_o = bound((BATCH * (n + mm) * c) * es + BATCH * n * 4,
                             2.0 * BATCH * n * mm * c, PEAK_OPS_PER_S[dtype])
            b_ms, b_by = max(t_b, t_o), "bytes" if t_b >= t_o else "operations"
            print(f"(b) attention {tag} B={BATCH} N={n} M={mm} C={c} "
                  f"h={heads}: max_abs_err={err:.3g} max_rel_err="
                  f"{rel.item():.3g} (tol {ATTN_TOL}) kernel_ms={t_k:.4f} "
                  f"plain_ms={t_p:.4f} bound_ms={b_ms:.4f} ({b_by})")
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if dtype == torch.bfloat16:
                r["ms"] += per_fwd * t_k
                r["plain_ms"] += per_fwd * t_p
                add_bound(r, per_fwd, t_b, t_o)
        r = rec["upsample_bicubic_x2"]
        for seed, (hh, ww, c, per_fwd) in enumerate(up_shapes + [ragged_up]):
            x = randn((BATCH, hh, ww, c), 200 + seed, dtype)
            got = upsample_bicubic_x2(x)
            want = upsample_bicubic_x2_reference(x)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got, want, **UPSAMPLE_TOL)
            t_k = device_ms(lambda: upsample_bicubic_x2(x))
            t_p = cuda_ms(lambda: upsample_bicubic_x2_reference(x), iters=5)
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last view, no copy
            t_l = device_ms(lambda: F.interpolate(
                x_nchw, scale_factor=2, mode="bicubic", align_corners=False))
            n_in = BATCH * hh * ww * c
            t_b, t_o = bound(5 * n_in * es, 42.0 * n_in, FP32_OPS_PER_S)
            b_ms, b_by = max(t_b, t_o), "bytes" if t_b >= t_o else "operations"
            print(f"(b) upsample {tag} B={BATCH} H={hh} W={ww} C={c}: "
                  f"max_abs_err={err:.3g} (tol {UPSAMPLE_TOL}) "
                  f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
                  f"library_ms={t_l:.4f} bound_ms={b_ms:.4f} ({b_by}, "
                  f"{100 * b_ms / t_k:.1f} % of it)")
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if dtype == torch.bfloat16:
                r["ms"] += per_fwd * t_k
                r["plain_ms"] += per_fwd * t_p
                r["library_ms"] += per_fwd * t_l
                add_bound(r, per_fwd, t_b, t_o)
    r = rec["upsample_bicubic_x2"]
    print(f"(b) upsample bf16 per batch-{BATCH} forward (5 launches): "
          f"kernel_ms={r['ms']:.4f} (earlier design: {UPSAMPLE_EARLIER_MS}) "
          f"bound_ms={r['bound_ms']:.4f}, {100 * r['bound_ms'] / r['ms']:.1f}"
          f" % of the bound")
    r = rec["gelu_bf16"]
    for seed, (shape, per_fwd) in enumerate(gelu_shapes):
        x = randn(shape, 400 + seed, torch.bfloat16)
        got = gelu_bf16(x)
        want = gelu_bf16_reference(x)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        require(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                ("gelu_bf16 not bit for bit", shape, err))
        t_k = device_ms(lambda: gelu_bf16(x))
        t_p = cuda_ms(lambda: gelu_bf16_reference(x), iters=5)
        # yardstick: torch's one-call tanh GELU, which rounds once instead
        # of after each operation (not bit for bit with JAX)
        t_l = device_ms(lambda: F.gelu(x, approximate="tanh"))
        t_b, t_o = bound(4 * x.numel(), 20.0 * x.numel(), FP32_OPS_PER_S)
        print(f"(b) gelu bf16 {tuple(shape)} x{per_fwd}: bit for bit, "
              f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f} library_ms="
              f"{t_l:.4f} bound_ms={max(t_b, t_o):.4f}")
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += per_fwd * t_k
        r["plain_ms"] += per_fwd * t_p
        r["library_ms"] += per_fwd * t_l
        add_bound(r, per_fwd, t_b, t_o)
        del x, got, want
    # every bf16 input, in storage aligned to 16 bytes (the vector path)
    # and one element in (the element-by-element path)
    every = every_bf16()
    for x in (every, every[1:]):
        require(same_bits(gelu_bf16(x), gelu_bf16_reference(x)),
                ("gelu_bf16 not bit for bit on every input",
                 x.data_ptr() % 16))
    print("(b) gelu bf16: bit for bit on all 65,536 bf16 inputs, aligned "
          "and not")
    r = rec["gelu_bf16"]
    print(f"(b) gelu bf16 per batch-{BATCH} forward: kernel_ms="
          f"{r['ms']:.4f} (earlier design: {GELU_EARLIER_MS}) library_ms="
          f"{r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f}, "
          f"{100 * r['bound_ms'] / r['ms']:.1f} % of the bound")
    for name, r in rec.items():
        print(f"(b) {name}: per bf16 batch-{BATCH} forward kernel_ms="
              f"{r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms="
              f"{r['library_ms']} bound_ms={r['bound_ms']:.4f}")
    return rec


def gelu_forward_shapes(cfg):
    """([B, ...] shape, launches per forward) of every bf16 GELU of the
    `base` forward: the MixFFN of each encoder block, the four 1x1
    from-encoder ConvLayers and the ShortResBlock ConvLayers of the five
    decoder stages."""
    m = cfg.model
    shapes = {}
    for i in range(4):
        fh, fw = m.feature_shape(i)
        ffn = (BATCH, fh * fw, int(m.dims[i] * m.ff_expansion[i]))
        shapes[ffn] = shapes.get(ffn, 0) + m.depths[i]
        enc = (BATCH, fh, fw, m.dims[i])
        shapes[enc] = shapes.get(enc, 0) + 1
    for hh, ww, _, convs in conv_stages(cfg):
        for n, _ in convs:
            shapes[(BATCH, hh, ww, n)] = shapes.get((BATCH, hh, ww, n), 0) + 1
    return sorted(shapes.items())


def golden_weights():
    from camradepth_tpu_torch.interop.golden import (
        shapes_from_json,
        synth_state_values,
    )

    with np.load(ROOT / "tests" / "goldens" / "flagship_416x800.npz") as z:
        golden = {k: z[k] for k in z.files if k != "shapes_json"}
        shapes = shapes_from_json(bytes(z["shapes_json"]).decode())
    return golden, synth_state_values(shapes)


def phase_c(cfg, golden, weights, counters):
    from camradepth_tpu_torch.interop.golden import golden_input
    from camradepth_tpu_torch.models.camradepth import create_model

    model_cfg = dataclasses.replace(cfg.model, compute_dtype="float32")
    model = create_model(model_cfg, device="cuda", state_dict=weights)
    x = torch.from_numpy(golden_input(model_cfg.img_size)).cuda()
    before = counters()
    with torch.inference_mode():
        out = model(x)
    torch.cuda.synchronize()
    after = counters()
    launches = tuple(a - b for a, b in zip(after, before))
    want = (sum(model_cfg.depths), 5, 0, 0)
    print(f"(c) 416x800 fp32 forward: launches (attention, upsample, conv, "
          f"gelu) {launches} (expected {want})")
    require(launches == want, (launches, want))
    final = out["depth"]["final_depth"].cpu().numpy()
    inter2 = out["depth"]["intermediate_depths"][2].cpu().numpy()
    inter3 = out["depth"]["intermediate_depths"][3].cpu().numpy()
    cy, cx = golden["crop_yx"]
    checks = [
        ("final_depth_crop", final[:, cy:cy + 64, cx:cx + 128],
         golden["final_depth_crop"], 2e-3, 5e-4),
        ("final_depth_f16", final,
         golden["final_depth_f16"].astype(np.float32), 2e-3, 1.5e-3),
        ("inter2", inter2, golden["inter2"], 2e-3, 5e-4),
        ("inter3_f16", inter3, golden["inter3_f16"].astype(np.float32),
         2e-3, 1.5e-3),
    ]
    for name, got, ref, rtol, atol in checks:
        err = np.abs(got - ref).max()
        print(f"(c) {name}: max_abs_err={err:.3g} (rtol {rtol}, atol {atol})")
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                                   err_msg=name)
    return model


def per_forward(cfg, n_fwd):
    """Launches (attention, upsample, conv, gelu) of n_fwd bf16 forwards."""
    n_gelu = sum(n for _, n in gelu_forward_shapes(cfg))
    return (n_fwd * sum(cfg.model.depths), n_fwd * 5, 0, n_fwd * n_gelu)


def phase_d(cfg, weights, ref_model, counters, reset_counters):
    from camradepth_tpu_torch.serving import load_engine

    h, w = cfg.model.img_size
    n_frames = 3 * BATCH + 3  # three full batches and a ragged tail
    rng = np.random.default_rng(11)
    frames = rng.standard_normal((n_frames, h, w, cfg.model.input_channels),
                                 dtype=np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "base_synth.pth"
        torch.save({"state_dict": {k: torch.from_numpy(v)
                                   for k, v in weights.items()}}, path)
        t0 = time.perf_counter()
        engine = load_engine(cfg, str(path), batch_size=BATCH,
                             device="cuda")
        print(f"(d) load_engine (bf16, batch {BATCH}) with warm-up: "
              f"{time.perf_counter() - t0:.2f} s")

    engine.reset_stats()
    reset_counters()
    results = list(engine.infer_stream(iter(frames)))
    launches = counters()
    stats = engine.stats()
    n_batches = -(-n_frames // BATCH)
    want = per_forward(cfg, n_batches)
    print(f"(d) served {len(results)} frames in {n_batches} batches: "
          f"kernel launches {launches} (expected {want}); "
          f"frames_per_sec={stats['frames_per_sec']:.2f} "
          f"batch_ms_p50={stats['batch_ms_p50']:.2f}")
    require(launches == want, (launches, want))
    require(len(results) == n_frames, len(results))
    for r in results:
        d = r["depth"]
        require(d.shape == (h, w) and np.isfinite(d).all(), d.shape)
        require(0.0 <= d.min() and d.max() <= cfg.data.max_depth,
                (d.min(), d.max()))

    # bf16 against the fp32 forward on the same weights: the first frame,
    # one in the middle, and the last (of the ragged tail batch)
    picks = [0, n_frames // 2, n_frames - 1]
    x = torch.from_numpy(frames[picks]).cuda()
    with torch.inference_mode():
        d = ref_model(x)["depth"]["final_depth"][..., 0].clamp(0.0, 1.0)
    ref = (cfg.data.max_depth * (1.0 - d)).cpu().numpy()
    for j, i in enumerate(picks):
        own = np.abs(results[i]["depth"] - ref[j]).mean()
        other = np.abs(results[i]["depth"] - ref[(j + 1) % 3]).mean()
        print(f"(d) frame {i}: mean |bf16 - fp32| = {own:.4f} m "
              f"(tol {SERVE_MEAN_ABS_M}); against another frame "
              f"{other:.4f} m")
        require(own <= SERVE_MEAN_ABS_M and own < 0.25 * other,
                (i, own, other))

    # a steadier throughput reading: 12 batches of the same frames
    engine.reset_stats()
    for _ in engine.infer_stream(frames[i % n_frames]
                                 for i in range(12 * BATCH)):
        pass
    stats = engine.stats()
    print(f"(d) steady stream of {12 * BATCH} frames: frames_per_sec="
          f"{stats['frames_per_sec']:.2f} batch_ms_p50="
          f"{stats['batch_ms_p50']:.2f} batch_ms_p95="
          f"{stats['batch_ms_p95']:.2f}")
    return launches, engine, frames, stats


def phase_e(engine, frames, stream_stats, counters, reset_counters,
            top: int = 12):
    """Where a bf16 batch-8 forward spends its device time: torch.profiler
    over one forward, CUDA kernels summed by name. The device's idle share
    is that device time against the steady stream's time per batch (host
    clock, no profiler)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(frames[:BATCH]).cuda()
    with torch.inference_mode():
        engine.model(x)
        torch.cuda.synchronize()
        reset_counters()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches = counters()
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    batch_ms = 1e3 * stream_stats["elapsed_s"] / stream_stats["batches"]
    print(f"(e) profiled bf16 batch-{BATCH} forward: device busy "
          f"{busy_ms:.2f} ms, {sum(e.count for e in kernels)} kernel "
          f"launches; wall {wall_ms:.2f} ms with the profiler on; Hopper "
          f"kernel launches (attention, upsample, conv, gelu) {launches}")
    print(f"(e) steady stream: {batch_ms:.2f} ms per batch (no profiler); "
          f"device idle share {100 * (1 - busy_ms / batch_ms):.1f} %")
    for e in kernels[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"(e)   {ms:8.3f} ms {100 * ms / busy_ms:5.1f} % x{e.count:<4d} "
              f"{e.key[:100]}")
    for name in ("scores_", "upsample_kernel", "gelu_bf16_kernel"):
        sel = [e for e in kernels if name in e.key]
        ms = sum(e.self_device_time_total for e in sel) / 1e3
        print(f"(e) {name}: {ms:.3f} ms ({100 * ms / busy_ms:.1f} % of device"
              f" time), x{sum(e.count for e in sel)}")


@dataclasses.dataclass
class DeviceKernel:
    """A device kernel's launches in a profile, summed by name (the fields
    the profiler's own averages name so)."""

    key: str
    count: int = 0
    self_device_time_total: float = 0.0  # microseconds


def device_kernels(prof):
    """The profile's device kernels, summed by name, largest first. A
    user annotation (such as the optimizer's ``Optimizer.step#...`` range)
    also shows on the device timeline, spanning the kernels inside it; it
    is not a kernel and is left out, so the sum is the device's busy
    time. Read from the profile's raw events: ``prof.key_averages()``
    first builds a Python object for every event and their tree (18 s for
    200,000 events on an 8-core x86 host), longer than a profiled training
    step itself takes."""
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or e.is_user_annotation()
                or e.name().startswith(("Optimizer.", "ProfilerStep"))):
            continue
        k = by_name.setdefault(e.name(), DeviceKernel(e.name()))
        k.count += 1
        k.self_device_time_total += e.duration_ns() / 1e3
    return sorted(by_name.values(), key=lambda k: -k.self_device_time_total)


def bf16_ulps(got, want) -> float:
    """Largest |got - want| in bf16 ulps of the larger magnitude, taken at
    no less than 2**-7 of ``want``'s RMS (see CONV_BF16_ULPS)."""
    g, w = got.float(), want.float()
    floor = max(2.0**-7 * w.square().mean().sqrt().item(),
                torch.finfo(torch.bfloat16).tiny)
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(floor)
    ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(
        torch.log2(mag)))
    return ((g - w).abs() / ulp).max().item()


def conv_stages(cfg):
    """(H, W, K0, [(N, groups)] * 3) of each decoder stage's ShortResBlock,
    read from the port's own model (built on the meta device)."""
    from camradepth_tpu_torch.models.camradepth import CamRaDepth

    with torch.device("meta"):
        model = CamRaDepth(cfg.model)
    h, w = cfg.model.img_size
    stages = []
    for i, dec in enumerate(model.depth_upsample):
        layers = dec.conv.layers
        convs = [(layer.model[0].out_channels, layer.model[1].num_groups)
                 for layer in layers]
        stages.append((h // 16 * 2**i, w // 16 * 2**i,
                       layers[0].model[0].in_channels, convs))
    return stages


def conv_chain(stages, dtype, seed=300):
    """Run each stage's convs through conv3x3_fused, chained as
    ShortResBlock chains them: layer j reads the stage input and the raw
    outputs of layers < j through their GroupNorm affine
    (gn_affine_from_stats of those launches' sums) and GELU. Yields
    (H, W, sources, weights, (raw, sum, sqsum)) per conv."""
    from camradepth_tpu_torch.ops.conv_fused import (
        Source,
        conv3x3_fused,
        gn_affine_from_stats,
    )

    for i, (hh, ww, k0, convs) in enumerate(stages):
        rng = np.random.default_rng(seed + i)
        sources = [Source(randn((BATCH, hh, ww, k0), seed + i, dtype))]
        for n, groups in convs:
            k = sum(src.x.shape[-1] for src in sources)
            wt = torch.from_numpy((rng.standard_normal((3, 3, k, n))
                                   / np.sqrt(9 * k)).astype(np.float32))
            wt = wt.to(device="cuda", dtype=dtype)
            out = conv3x3_fused(sources, wt)
            yield hh, ww, sources, wt, out
            gamma = torch.from_numpy((1 + 0.1 * rng.standard_normal(n))
                                     .astype(np.float32)).cuda()
            beta = torch.from_numpy((0.1 * rng.standard_normal(n))
                                    .astype(np.float32)).cuda()
            sc, sh = gn_affine_from_stats(out[1], out[2], hh * ww, gamma,
                                          beta, groups)
            sources = sources + [Source(out[0], sc, sh, True)]


def phase_f(cfg, counters, reset_counters):
    """The fused conv: its main path (the 15 chained convs through
    conv3x3_fused), then kernel vs plain at each shape and a ragged one."""
    from camradepth_tpu_torch.ops.conv_fused import (
        _transformed,
        conv3x3_fused,
        conv3x3_reference,
    )

    stages = conv_stages(cfg)
    n_convs = sum(len(c) for _, _, _, c in stages)
    print(f"(f) ShortResBlock convs of the port's model: " + "; ".join(
        f"{hh}x{ww} K0={k0} N={[n for n, _ in c]}"
        for hh, ww, k0, c in stages))
    reset_counters()
    for *_, out in conv_chain(stages, torch.bfloat16):
        del out
    torch.cuda.synchronize()
    launches = counters()
    print(f"(f) main path: {n_convs} chained bf16 convs, launches "
          f"(attention, upsample, conv, gelu) = {launches}")
    require(launches == (0, 0, n_convs, 0), launches)

    r = dict(route="cuda", source="camradepth_tpu_torch/csrc/conv3x3_fused.cu",
             replaces="camradepth_tpu/ops/conv_fused.py:316", max_abs_err=0.0,
             ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
             bound_by=None, launches=launches[2])
    # odd H, W, K and N off the tiles; a 1-row image with N = 8 and 72; a
    # 13-channel source, so the next starts inside a 16-byte vector, N = 128
    ragged = [(37, 53, 45, [(13, 1), (70, 1)]),
              (1, 29, 40, [(8, 1), (72, 1)]),
              (12, 21, 13, [(128, 8), (8, 1)])]
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.finfo(dtype).bits // 8
        tag = str(dtype).removeprefix("torch.")
        for set_i, st in enumerate((stages, ragged)):
            for hh, ww, sources, wt, got in conv_chain(st, dtype):
                want = conv3x3_reference(sources, wt)
                torch.cuda.synchronize()
                k, n = wt.shape[2], wt.shape[3]
                err = (got[0].float() - want[0].float()).abs().max().item()
                if dtype == torch.bfloat16:
                    ulps = bf16_ulps(got[0], want[0])
                    require(ulps <= CONV_BF16_ULPS, (hh, ww, k, n, ulps))
                    how = f"{ulps:.2f} bf16 ulps (tol {CONV_BF16_ULPS})"
                else:
                    torch.testing.assert_close(got[0], want[0],
                                               **CONV_F32_TOL)
                    how = f"tol {CONV_F32_TOL}"
                atol = 1e-3 * (hh * ww) ** 0.5
                for g, wnt in zip(got[1:], want[1:]):
                    torch.testing.assert_close(g, wnt, rtol=CONV_SUM_RTOL,
                                               atol=atol)
                serr = max((g - wnt).abs().max().item()
                           for g, wnt in zip(got[1:], want[1:]))
                r["max_abs_err"] = max(r["max_abs_err"], err)
                line = (f"(f) conv {tag} B={BATCH} {hh}x{ww} K={k} N={n} "
                        f"sources={len(sources)}: raw max_abs_err={err:.3g} "
                        f"({how}) sums max_abs_err={serr:.3g} (rtol "
                        f"{CONV_SUM_RTOL}, atol {atol:.3g})")
                if set_i == 0 and dtype == torch.bfloat16:
                    t_k = device_ms(lambda: conv3x3_fused(sources, wt),
                                    iters=5)
                    t_p = cuda_ms(lambda: conv3x3_reference(sources, wt),
                                  iters=3)
                    # library yardstick: cuDNN's bf16 conv over the already
                    # transformed concat (no transform, no statistics)
                    x_cat = torch.cat([_transformed(src) for src in sources],
                                      dim=-1).permute(0, 3, 1, 2)
                    w_l = wt.permute(3, 2, 0, 1).contiguous(
                        memory_format=torch.channels_last)
                    t_l = device_ms(lambda: F.conv2d(x_cat, w_l, padding=1),
                                    iters=5)
                    del x_cat, w_l
                    bytes_moved = (sum(src.x.numel() for src in sources)
                                   + wt.numel() + got[0].numel()) * es + (
                        2 * BATCH * n * 4)
                    t_b, t_o = bound(bytes_moved,
                                     2.0 * BATCH * hh * ww * 9 * k * n,
                                     PEAK_OPS_PER_S[dtype])
                    r["ms"] += t_k
                    r["plain_ms"] += t_p
                    r["library_ms"] += t_l
                    add_bound(r, 1, t_b, t_o)
                    line += (f" kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
                             f"library_ms={t_l:.4f} bound_ms="
                             f"{max(t_b, t_o):.4f}")
                print(line)
                del got, want
        torch.cuda.empty_cache()
    print(f"(f) conv3x3_fused: set of {n_convs} bf16 batch-{BATCH} convs "
          f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
          f"library_ms={r['library_ms']:.4f} (cuDNN conv only) bound_ms="
          f"{r['bound_ms']:.4f} ({r['bound_by']})")
    return r


def run_cli(argv):
    """``camradepth_tpu_torch.cli.main(argv)`` in this process; returns
    (exit code, its standard output)."""
    from camradepth_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


# the frames of (g)'s and (i)'s corpora that cli test runs on the CPU too:
# one sunny frame and one rain frame (every 4th), so that the edge and
# sunny metrics both compare; two frames of 416x800 keep the CPU's forwards
# to ~10 s on the card's host
CPU_FRAMES = slice(2, 4)


def phase_g(cfg, weights, counters, reset_counters, tmp):
    """cli test (bf16 and fp32) and cli serve on the card at base 416x800,
    batch 8, over a 32-frame synthetic corpus written into ``tmp``, which
    phase (l) reads again; returns the split and the .pth."""
    from camradepth_tpu_torch.data import synthetic
    from camradepth_tpu_torch.data.split import save_split

    h, w = cfg.model.img_size
    n_frames = 32
    fps = {}
    t0 = time.perf_counter()
    split = synthetic.generate(tmp / "data", num_frames=n_frames,
                               hw=(h, w), seed=0, rain_every=4)
    head = save_split(np.load(split)[CPU_FRAMES], tmp / "head_split.npy")
    pth = tmp / "base_synth.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in weights.items()}}, pth)
    print(f"(g) {n_frames}-frame {h}x{w} corpus and .pth written in "
          f"{time.perf_counter() - t0:.1f} s")
    common = ["--preset", "base", "--set", "data.mini_dataset=1",
              "--checkpoint", str(pth), "--test-batch", str(BATCH)]
    f32 = ["--set", "model.compute_dtype=float32"]

    def test(name, extra, device="cuda", split_path=split):
        path = tmp / f"{name}.json"
        reset_counters()
        rc, out = run_cli(["test", "--split", str(split_path),
                           "--report-json", str(path), "--device",
                           device] + common + extra)
        torch.cuda.synchronize()
        launches = counters()
        require(rc == 0, (name, rc, out))
        report = json.loads(path.read_text())
        require(tuple(sorted(report)) == tuple(sorted(REPORT_KEYS)),
                (name, sorted(set(report) ^ set(REPORT_KEYS))))
        require(all(np.isfinite(v) for v in report.values()),
                (name, report))
        print(f"(g) cli test {name}: frames={report['frames']:.0f} "
              f"rmse_100={report['rmse_100']:.4f} mae_100="
              f"{report['mae_100']:.4f} rmse_50={report['rmse_50']:.4f} "
              f"mae_50={report['mae_50']:.4f} rmse_edge="
              f"{report['rmse_edge']:.4f} rmse_sunny="
              f"{report['rmse_sunny']:.4f} frames_per_sec_end_to_end="
              f"{report['frames_per_sec_end_to_end']:.2f} "
              f"frames_per_sec_steady="
              f"{report['frames_per_sec_steady']:.2f}; launches "
              f"{launches}")
        return report, launches

    bf16, launches = test("bf16", [])
    want = per_forward(cfg, n_frames // BATCH)
    require(bf16["frames"] == n_frames, bf16["frames"])
    require(launches == want, (launches, want))
    fps["test_bf16"] = bf16["frames_per_sec_steady"]
    fp32, _ = test("fp32", f32)
    fps["test_fp32"] = fp32["frames_per_sec_steady"]
    for k in ("rmse_100", "mae_100", "rmse_50", "mae_50"):
        d = abs(bf16[k] - fp32[k])
        print(f"(g) {k}: |bf16 - fp32| = {d:.4f} m (tol "
              f"{SERVE_MEAN_ABS_M})")
        require(d <= SERVE_MEAN_ABS_M, (k, bf16[k], fp32[k]))
    # batch 1, so that the 2 frames make two batches and the report has
    # its steady-rate keys
    head_f32 = f32 + ["--test-batch", "1"]
    card, _ = test("fp32_head", head_f32, split_path=head)
    cpu, _ = test("cpu_fp32_head", head_f32, device="cpu",
                  split_path=head)
    for k in METRIC_KEYS:
        require(abs(card[k] - cpu[k]) <= REPORT_RTOL * abs(cpu[k]),
                (k, card[k], cpu[k]))
    print(f"(g) cli test fp32 on the card = on the CPU over frames "
          f"{CPU_FRAMES.start} and {CPU_FRAMES.start + 1}, every metric "
          f"within rtol {REPORT_RTOL} "
          f"(rmse_100 {card['rmse_100']:.6f} vs {cpu['rmse_100']:.6f})")

    out_dir = tmp / "served"
    reset_counters()
    rc, out = run_cli(["serve", "--split", str(split), "--out",
                       str(out_dir), "--limit", str(n_frames),
                       "--serve-batch", str(BATCH)] + common[:-2])
    torch.cuda.synchronize()
    launches = counters()
    require(rc == 0, (rc, out))
    stats = json.loads(out.strip().splitlines()[-1])
    maps = sorted(out_dir.glob("*_depth.npy"))
    require(len(maps) == n_frames and stats["frames"] == n_frames,
            (len(maps), stats))
    for p in maps:
        d = np.load(p)
        require(d.shape == (h, w) and np.isfinite(d).all(), p)
    # and the engine's warm-up forward
    want = per_forward(cfg, n_frames // BATCH + 1)
    require(launches == want, (launches, want))
    fps["serve_bf16"] = stats["frames_per_sec"]
    print(f"(g) cli serve: {len(maps)} depth maps; frames_per_sec="
          f"{stats['frames_per_sec']:.2f} batch_ms_p50="
          f"{stats['batch_ms_p50']:.2f}; launches {launches} "
          f"(expected {want})")
    print("(g) frames/s: " + " ".join(f"{k}={v:.2f}" for k, v in fps.items()))
    return split, pth


# attention backward: dq is one product per element (bit for bit); dk sums
# the products in fp32 in another order than the plain scatter-add (rtol
# 1e-5, atol 1e-5; in bf16 the one rounding of those sums may land one bf16
# ulp apart). The argmax equals the plain one but at near ties (the top two
# dots within 1e-4 * (1 + |max|)), where it must be one of the tied keys.
ATTN_BWD_TOL = dict(rtol=1e-5, atol=1e-5)
ARGMAX_TIE = 1e-4
# fp32 step, card against the port's CPU run of the same step: loss and
# grad_norm rtol 1e-3, each parameter's gradient relative L2 error 1e-3
STEP_RTOL = 1e-3
STEP_GRAD_REL_L2 = 1e-3
TRAIN_BATCH = 2
# the teacher warm start of cli distill, base into base + tpu_decoder:
# tensors transferred, of the student's; tests/test_torch_distill.py
# derives it from the JAX package's partial_restore_params
DISTILL_WARM_START = (859, 881)


def argmax_near_ties(q, k, heads, amax):
    """Check the kernel's argmax against the plain fp32 dots; returns the
    number of near-tied rows (where either key is accepted)."""
    b, n, c = q.shape
    d = c // heads
    dots = torch.einsum("bnhd,bmhd->bhnm", q.float().reshape(b, n, heads, d),
                        k.float().reshape(b, -1, heads, d))
    top2 = dots.topk(min(2, dots.shape[-1]), dim=-1).values
    tol = ARGMAX_TIE * (1 + top2[..., 0].abs())
    tie = (top2[..., 0] - top2[..., -1] <= tol) & (dots.shape[-1] > 1)
    want = dots.argmax(dim=-1).to(torch.int32)
    require(bool(((amax == want) | tie).all()), "argmax differs off a tie")
    at = torch.gather(dots, -1, amax.long()[..., None])[..., 0]
    require(bool((top2[..., 0] - at <= tol).all()), "argmax not a max")
    return int(tie.sum())


def phase_h_kernels(cfg):
    """Each backward kernel against its plain version at every shape of a
    base 416x800 batch-2 microbatch and ragged ones, both dtypes; times
    summed per bf16 microbatch."""
    from camradepth_tpu_torch.ops.attention import (
        maxpool_attention_scores,
        maxpool_attention_scores_backward,
        maxpool_attention_scores_backward_reference,
        maxpool_attention_scores_with_argmax,
    )
    from camradepth_tpu_torch.ops.gelu import (
        gelu_bf16_backward,
        gelu_bf16_backward_reference,
    )
    from camradepth_tpu_torch.ops.resize import (
        upsample_bicubic_x2_backward,
        upsample_bicubic_x2_backward_reference,
    )

    m = cfg.model
    h, w = m.img_size
    b = TRAIN_BATCH
    attn = []
    for i in range(4):
        fh, fw = m.feature_shape(i)
        sr = m.sr_ratios[i]
        attn.append((b, fh * fw, (fh // sr) * (fw // sr), m.dims[i],
                     m.heads[i], m.depths[i]))
    # d = 8 below one token tile; d = 40 with M = 1; B = 3 with N, M ragged
    attn += [(2, 9, 33, 8, 1, 0), (1, 37, 1, 40, 1, 0),
             (3, 1001, 77, 120, 3, 0)]
    mid = m.mid_channels
    up = [(b, *m.feature_shape(3), m.dims[3], 1),
          (b, *m.feature_shape(2), mid, 1), (b, *m.feature_shape(1), mid, 1),
          (b, *m.feature_shape(0), mid + 1, 1), (b, h // 2, w // 2, mid + 1, 1),
          # C = 129 with B = 3; H = 1; W = 1 and C = 3 (rows off 16 bytes);
          # both edges' folds on one row or column (n = 1, 2)
          (3, 7, 9, 129, 0), (2, 1, 37, 16, 0), (2, 5, 1, 3, 0),
          (1, 1, 3, 2, 0), (2, 2, 1, 4, 0), (1, 5, 7, 129, 0)]
    gelu = [((b,) + shape[1:], n) for shape, n in gelu_forward_shapes(cfg)]
    gelu += [((3, 5, 7, 13), 0)]

    def row(source, replaces, library):
        return dict(route="cuda", source="camradepth_tpu_torch/csrc/" + source,
                    replaces=replaces, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                    bound_ms=0.0, library_ms=0.0 if library else None,
                    bound_by=None)

    rec = {
        "maxpool_attention_scores_backward": row(
            "maxpool_attention_scores_bwd.cu",
            "camradepth_tpu/ops/attention_pallas.py:76", False),
        "upsample_bicubic_x2_backward": row(
            "upsample_bicubic_x2_bwd.cu",
            "camradepth_tpu/ops/resize_pallas.py:209", True),
        "gelu_bf16_backward": row(
            "gelu_bf16.cu", "camradepth_tpu/models/layers.py:41", True),
    }
    argmax_ms = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.finfo(dtype).bits // 8
        tag = str(dtype).removeprefix("torch.")
        r = rec["maxpool_attention_scores_backward"]
        for seed, (bb, n, mm, c, heads, per_mb) in enumerate(attn):
            q = randn((bb, n, c), 500 + seed, dtype)
            k = randn((bb, mm, c), 600 + seed, dtype)
            g = randn((bb, n), 700 + seed, torch.float32)
            scale = (c // heads) ** -0.5
            s, amax = maxpool_attention_scores_with_argmax(q, k, heads, scale)
            require(torch.equal(s, maxpool_attention_scores(q, k, heads,
                                                            scale)),
                    ("argmax launch changed the scores", n, c))
            ties = argmax_near_ties(q, k, heads, amax)
            dq, dk = maxpool_attention_scores_backward(q, k, amax, g, heads,
                                                       scale)
            wq, wk = maxpool_attention_scores_backward_reference(
                q, k, amax, g, heads, scale)
            torch.cuda.synchronize()
            require(torch.equal(dq, wq), ("dq not bit for bit", n, c, tag))
            if dtype == torch.bfloat16:
                ulps = bf16_ulps(dk, wk)
                require(ulps <= 1.0, ("dk", n, c, ulps))
                how = f"dk {ulps:.2f} bf16 ulps (tol 1)"
            else:
                torch.testing.assert_close(dk, wk, **ATTN_BWD_TOL)
                how = f"dk tol {ATTN_BWD_TOL}"
            dk2 = maxpool_attention_scores_backward(q, k, amax, g, heads,
                                                    scale)[1]
            require(torch.equal(dk, dk2), "dk not deterministic")
            err = (dk.float() - wk.float()).abs().max().item()
            t_k = device_ms(lambda: maxpool_attention_scores_backward(
                q, k, amax, g, heads, scale))
            t_a = device_ms(lambda: maxpool_attention_scores_with_argmax(
                q, k, heads, scale))
            t_p = cuda_ms(lambda: maxpool_attention_scores_backward_reference(
                q, k, amax, g, heads, scale), iters=3)
            # q, k, amax and g read once, dq and dk written once; a gather
            # product per dq element, a product and a sum per dk term
            t_b, t_o = bound(2 * bb * (n + mm) * c * es + bb * heads * n * 4
                             + bb * n * 4, 4.0 * bb * n * c, FP32_OPS_PER_S)
            print(f"(h) attention backward {tag} B={bb} N={n} M={mm} C={c} "
                  f"h={heads}: argmax equal ({ties} near ties), dq bit for "
                  f"bit, {how}, deterministic; kernel_ms={t_k:.4f} "
                  f"plain_ms={t_p:.4f} bound_ms={max(t_b, t_o):.4f}; "
                  f"forward with argmax {t_a:.4f} ms")
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if dtype == torch.bfloat16:
                r["ms"] += per_mb * t_k
                r["plain_ms"] += per_mb * t_p
                add_bound(r, per_mb, t_b, t_o)
                argmax_ms += per_mb * t_a
            del q, k, g, s, amax, dq, dk, wq, wk, dk2
        r = rec["upsample_bicubic_x2_backward"]
        for seed, (bb, hh, ww, c, per_mb) in enumerate(up):
            gy = randn((bb, 2 * hh, 2 * ww, c), 800 + seed, dtype)
            got = upsample_bicubic_x2_backward(gy)
            want = upsample_bicubic_x2_backward_reference(gy)
            torch.cuda.synchronize()
            require(torch.equal(got, want), ("bicubic adjoint not bit for "
                                             "bit", hh, ww, c, tag))
            t_k = device_ms(lambda: upsample_bicubic_x2_backward(gy))
            t_p = cuda_ms(lambda: upsample_bicubic_x2_backward_reference(gy),
                          iters=3)
            # one ATen call: the adjoint of F.interpolate(bicubic), which
            # reads NCHW (the NHWC view is copied) and adds by atomics
            gy_nchw = gy.permute(0, 3, 1, 2)
            t_l = device_ms(lambda: torch.ops.aten.upsample_bicubic2d_backward(
                gy_nchw, [2 * hh, 2 * ww], [bb, c, hh, ww], False, 2.0, 2.0))
            n_in = bb * hh * ww * c
            # gy read once, gx written once; 8 products and sums per output
            # of each axis
            t_b, t_o = bound(5 * n_in * es, 48.0 * n_in, FP32_OPS_PER_S)
            print(f"(h) upsample backward {tag} B={bb} H={hh} W={ww} C={c}: "
                  f"bit for bit; kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
                  f"library_ms={t_l:.4f} bound_ms={max(t_b, t_o):.4f}")
            if dtype == torch.bfloat16:
                r["ms"] += per_mb * t_k
                r["plain_ms"] += per_mb * t_p
                r["library_ms"] += per_mb * t_l
                add_bound(r, per_mb, t_b, t_o)
            del gy, got, want, gy_nchw
    r = rec["gelu_bf16_backward"]
    for seed, (shape, per_mb) in enumerate(gelu):
        x = randn(shape, 900 + seed, torch.bfloat16)
        gy = randn(shape, 950 + seed, torch.bfloat16)
        got = gelu_bf16_backward(x, gy)
        want = gelu_bf16_backward_reference(x, gy)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                ("gelu backward not bit for bit", shape))
        t_k = device_ms(lambda: gelu_bf16_backward(x, gy))
        t_p = cuda_ms(lambda: gelu_bf16_backward_reference(x, gy), iters=3)
        # one ATen call: torch's tanh-GELU backward, which rounds once
        t_l = device_ms(lambda: torch.ops.aten.gelu_backward(
            gy, x, approximate="tanh"))
        t_b, t_o = bound(6 * x.numel(), 40.0 * x.numel(), FP32_OPS_PER_S)
        print(f"(h) gelu backward bf16 {tuple(shape)} x{per_mb}: bit for bit;"
              f" kernel_ms={t_k:.4f} plain_ms={t_p:.4f} library_ms="
              f"{t_l:.4f} bound_ms={max(t_b, t_o):.4f}")
        r["ms"] += per_mb * t_k
        r["plain_ms"] += per_mb * t_p
        r["library_ms"] += per_mb * t_l
        add_bound(r, per_mb, t_b, t_o)
        del x, gy, got, want
    # every bf16 x against every cotangent of the sweep, aligned, and one
    # element in (the element-by-element path) over the first 4 rows
    cot = cotangent_sweep()
    x = every_bf16().repeat(cot.numel(), 1)
    gy = cot[:, None].expand_as(x).contiguous()
    require(same_bits(gelu_bf16_backward(x, gy),
                      gelu_bf16_backward_reference(x, gy)),
            "gelu backward not bit for bit on the sweep")
    n = 4 * x.shape[1]
    xs, gs = x.view(-1)[1:n], gy.view(-1)[1:n]
    require(same_bits(gelu_bf16_backward(xs, gs),
                      gelu_bf16_backward_reference(xs, gs)),
            "gelu backward not bit for bit off 16 bytes")
    print(f"(h) gelu backward bf16: bit for bit on all 65,536 x times "
          f"{cot.numel()} cotangents (every exponent field of both signs, "
          f"+-0, subnormals, +-inf, NaN), aligned and not")
    del x, gy, xs, gs
    r = rec["gelu_bf16_backward"]
    print(f"(h) gelu backward per bf16 batch-{TRAIN_BATCH} microbatch: "
          f"kernel_ms={r['ms']:.4f} (earlier design: {GELU_BWD_EARLIER_MS})"
          f" library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f}, "
          f"{100 * r['bound_ms'] / r['ms']:.1f} % of the bound")
    for name, earlier in (("maxpool_attention_scores_backward",
                           ATTN_BWD_EARLIER_MS),
                          ("upsample_bicubic_x2_backward",
                           ADJOINT_EARLIER_MS)):
        r = rec[name]
        share = 100 * r["bound_ms"] / r["ms"]
        print(f"(h) {name} per bf16 batch-{TRAIN_BATCH} microbatch: "
              f"kernel_ms={r['ms']:.4f} (earlier design: {earlier}) "
              f"bound_ms={r['bound_ms']:.4f}, {share:.1f} % of the bound")
    one_key_attention_backward()
    torch.cuda.empty_cache()
    for name, r in rec.items():
        print(f"(h) {name}: per bf16 batch-{TRAIN_BATCH} microbatch "
              f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']})")
    print(f"(h) attention forward with argmax: {argmax_ms:.4f} ms per bf16 "
          f"batch-{TRAIN_BATCH} microbatch (34 launches)")
    return rec


def one_key_attention_backward(key=123):
    """The attention backward in bf16 where every token's argmax is one key
    (k's row ``key`` dominant; q's entries multiples of 1/8 in [0, 4), g
    integers, so that every sum of products is exact in fp32), at stages 1
    and 2 of a batch-2 microbatch: held to the limits of (h) and timed
    apart from the per-microbatch sums."""
    from camradepth_tpu_torch.ops.attention import (
        maxpool_attention_scores_backward,
        maxpool_attention_scores_backward_reference,
        maxpool_attention_scores_with_argmax,
    )

    for bb, n, mm, c, heads in ((TRAIN_BATCH, 20800, 325, 64, 1),
                                (TRAIN_BATCH, 5200, 325, 128, 2)):
        rng = np.random.default_rng(30)
        qn = np.floor(np.abs(rng.standard_normal((bb, n, c))) * 8).clip(
            0, 31) / 8
        kn = rng.standard_normal((bb, mm, c))
        kn[:, key] = 4.0
        q, k = (torch.from_numpy(a.astype(np.float32)).to("cuda",
                                                          torch.bfloat16)
                for a in (qn, kn))
        g = torch.from_numpy(rng.integers(-8, 9, (bb, n)).astype(
            np.float32)).cuda()
        scale = (c // heads) ** -0.5
        amax = maxpool_attention_scores_with_argmax(q, k, heads, scale)[1]
        require(bool((amax == key).all()), "one-key argmax")
        dq, dk = maxpool_attention_scores_backward(q, k, amax, g, heads,
                                                   scale)
        wq, wk = maxpool_attention_scores_backward_reference(
            q, k, amax, g, heads, scale)
        require(torch.equal(dq, wq), "one-key dq not bit for bit")
        ulps = bf16_ulps(dk, wk)
        require(ulps <= 1.0, ("one-key dk", ulps))
        require(torch.equal(dk, maxpool_attention_scores_backward(
            q, k, amax, g, heads, scale)[1]), "one-key dk not deterministic")
        t_k = device_ms(lambda: maxpool_attention_scores_backward(
            q, k, amax, g, heads, scale))
        print(f"(h) attention backward bf16, every token's argmax one key, "
              f"B={bb} N={n} M={mm} C={c} h={heads}: dq bit for bit, dk "
              f"{ulps:.2f} bf16 ulps (tol 1), deterministic; kernel_ms="
              f"{t_k:.4f} (one call, not in the sums)")
        del q, k, g, amax, dq, dk, wq, wk


def step_inputs(cfg, b, seed, device):
    """A microbatch of random features and sparse inverse-depth GT, and
    for a supervised seg branch random labels (5 % ignored)."""
    h, w = cfg.model.img_size
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, h, w, cfg.model.input_channels),
                                dtype=np.float32)
    gt = rng.uniform(0.01, 1.0, (b, h, w)).astype(np.float32)
    gt *= rng.uniform(size=(b, h, w)) < 0.25
    out = {"features": torch.from_numpy(feats).to(device),
           "gt_depth": torch.from_numpy(gt).to(device)}
    if cfg.model.supervised_seg:
        for key, (hh, ww) in (("seg", (h, w)), ("seg_inter", (h // 2,
                                                              w // 2))):
            lab = rng.integers(0, cfg.model.num_classes, (b, hh, ww))
            lab[rng.uniform(size=lab.shape) < 0.05] = 255
            out[key] = torch.from_numpy(lab.astype(np.int32)).to(device)
    return out


def phase_h_step_parity(cfg):
    """One fp32 optimizer step of base at 128x256 with dropout off, on the
    card and on the CPU from the same weights and inputs."""
    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.train.diffgrad import DiffGradNorm
    from camradepth_tpu_torch.train.step import train_step

    mcfg = dataclasses.replace(cfg.model, img_size=(128, 256),
                               compute_dtype="float32", drop_path_rate=0.0,
                               dropout_rate=0.0)
    scfg = cfg.replace(model=mcfg)
    results = {}
    t0 = time.perf_counter()
    for dev in ("cuda", "cpu"):
        model = create_model(mcfg, device=dev, seed=3, train=True)
        opt = DiffGradNorm(model.parameters(), lr=1e-4)
        micro = [step_inputs(scfg, TRAIN_BATCH, 31, dev)]
        metrics = train_step(scfg, model, opt, micro, [None], 1e-4)
        results[dev] = ({k: float(v) for k, v in metrics.items()},
                        {n: p.grad.detach().double().cpu()
                         for n, p in model.named_parameters()})
        del model, opt, micro
    (mc, gc), (mp, gp) = results["cuda"], results["cpu"]
    for k in ("loss", "grad_norm"):
        require(abs(mc[k] - mp[k]) <= STEP_RTOL * abs(mp[k]),
                (k, mc[k], mp[k]))
    worst, worst_name = 0.0, None
    for name, g in gp.items():
        rel = ((gc[name] - g).norm() / g.norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    require(worst <= STEP_GRAD_REL_L2, (worst_name, worst))
    print(f"(h) fp32 step of base at 128x256, batch {TRAIN_BATCH}, card vs "
          f"CPU: loss {mc['loss']:.7f} vs {mp['loss']:.7f}, grad_norm "
          f"{mc['grad_norm']:.7f} vs {mp['grad_norm']:.7f} (rtol "
          f"{STEP_RTOL}); worst gradient relative L2 error {worst:.3g} "
          f"({worst_name}; tol {STEP_GRAD_REL_L2}); "
          f"{time.perf_counter() - t0:.1f} s")


def per_microbatch(cfg, micro, evals):
    """Launches (attention, upsample, conv, gelu, attention backward,
    upsample backward, gelu backward) of ``micro`` bf16 training
    microbatches and ``evals`` bf16 eval forwards."""
    n_gelu = sum(n for _, n in gelu_forward_shapes(cfg))
    n_attn = sum(cfg.model.depths)
    fwd = micro + evals
    return (fwd * n_attn, fwd * 5, 0, fwd * n_gelu, micro * n_attn,
            micro * 5, micro * n_gelu)


def phase_h_train(cfg, counters, reset_counters):
    """The main path: cli train at base 416x800 bf16, batch 2 x 3, one
    epoch of 4 optimizer steps, eval, best checkpoint; then load_engine on
    that checkpoint, and one step under the profiler."""
    from camradepth_tpu_torch.data import synthetic
    from camradepth_tpu_torch.serving import load_engine
    from camradepth_tpu_torch.utils.checkpoint import best_checkpoint

    h, w = cfg.model.img_size
    n_train, n_val, accum = 24, 8, 3
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        split = synthetic.generate(tmp / "data", num_frames=n_train + n_val,
                                   hw=(h, w), seed=0, rain_every=4)
        run_dir = tmp / "run"
        argv = ["train", "--preset", "base", "--split", str(split),
                "--train-val-split", f"{n_train},{n_val}", "--run-dir",
                str(run_dir), "--save-model", "--batch-size",
                str(TRAIN_BATCH), "--desired-batch-size",
                str(TRAIN_BATCH * accum), "--num-epochs", "1", "--set",
                "train.log_every=1"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.perf_counter()
        rc, out = run_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counters()
        require(rc == 0, (rc, out[-2000:]))
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        steps = n_train // (TRAIN_BATCH * accum)
        evals = -(-n_val // TRAIN_BATCH)
        want = per_microbatch(cfg, steps * accum, evals)
        print(f"(h) cli train base 416x800 bf16 batch {TRAIN_BATCH} x "
              f"update_interval {accum}: {steps} optimizer steps + eval of "
              f"{n_val} frames in {wall:.1f} s; launches (attention, upsample,"
              f" conv, gelu, attention bwd, upsample bwd, gelu bwd) "
              f"{launches} (expected {want}: 34 + 34, 5 + 5, 53 + 53 per "
              f"microbatch, forwards only for eval)")
        require(launches == want, (launches, want))
        rows = [json.loads(line) for line in
                (run_dir / "metrics.jsonl").read_text().splitlines()]
        losses = [r["value"] for r in rows if r["tag"] == "train/loss"]
        rates = [r["value"] for r in rows if r["tag"] == "train/steps_per_sec"]
        val = [r["value"] for r in rows if r["tag"] == "val/loss"]
        require(len(losses) == steps and len(val) == 1, (losses, val))
        require(all(np.isfinite(v) for v in losses + val), (losses, val))
        best = best_checkpoint(run_dir)
        require(best is not None, "no best checkpoint written")
        print(f"(h) train losses {[round(v, 6) for v in losses]}, val loss "
              f"{val[0]:.6f}; steps_per_sec={rates[-1]:.3f} (epoch, loader "
              f"included); peak memory {peak_gb:.2f} GiB; best checkpoint "
              f"{best.name}")
        engine = load_engine(cfg, str(best), batch_size=TRAIN_BATCH,
                             device="cuda")
        frames = np.random.default_rng(5).standard_normal(
            (TRAIN_BATCH, h, w, cfg.model.input_channels), dtype=np.float32)
        res = engine.infer_batch(frames)
        d = res["depth"]
        require(d.shape == (TRAIN_BATCH, h, w) and np.isfinite(d).all(),
                d.shape)
        print(f"(h) load_engine served {len(d)} frames from {best.name}: "
              f"depth {d.min():.3f} .. {d.max():.3f} m")
        del engine
    profile_train_step(cfg, accum)
    return launches


def profile_train_step(cfg, accum, tag="(h)", teacher_cfg=None,
                       layout=None, top=14, warm=True):
    """One bf16 optimizer step (batch 2 x 3) timed without the profiler,
    and one under it: device busy, the idle share, peak memory and the
    largest ``top`` kernels; returns (wall ms, busy ms, peak GiB). With
    ``teacher_cfg``, a distill step (alpha 0.7, temperature 1) against a
    teacher of that config; with ``layout``, the model wrapped for it on
    this rank (``parallel/mesh.wrap``). Without ``warm`` no step runs
    before the timed one (the caller ran one of the same shapes)."""
    import functools

    from torch.profiler import ProfilerActivity, profile

    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.models.layers import GroupNorm
    from camradepth_tpu_torch.train.diffgrad import DiffGradNorm
    from camradepth_tpu_torch.train.distill import distill_loss
    from camradepth_tpu_torch.train.step import microbatch_loss, train_step
    from camradepth_tpu_torch.train.trainer import step_generator

    loss_fn, kind = microbatch_loss, "optimizer"
    if teacher_cfg is not None:
        teacher = create_model(teacher_cfg.model, device="cuda", seed=1)
        loss_fn = functools.partial(distill_loss, teacher=teacher, alpha=0.7,
                                    temperature=1.0)
        kind = "distill"
    model = create_model(cfg.model, device="cuda", seed=0, train=True)
    casts = sum(1 for mod in model.modules() if not isinstance(mod, GroupNorm)
                for _ in mod.parameters(recurse=False))
    if layout is not None:
        from camradepth_tpu_torch.parallel.mesh import wrap

        model = wrap(model, layout)
    opt = DiffGradNorm(model.parameters(), lr=1e-5)
    micro = [step_inputs(cfg, TRAIN_BATCH, 40 + j, "cuda")
             for j in range(accum)]
    for mb in micro:
        mb["features"] = mb["features"].to(torch.bfloat16)
    dev = torch.device("cuda")

    def step(i):
        gens = [step_generator(dev, 0, 0, i, j) for j in range(accum)]
        return train_step(cfg, model, opt, micro, gens, 1e-5,
                          loss_fn=loss_fn)

    if warm:
        step(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step(1)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(2)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{tag} one bf16 {kind} step (batch {TRAIN_BATCH} x {accum}): "
          f"{wall_ms:.2f} ms wall without the profiler, device busy "
          f"{busy_ms:.2f} ms under it, {sum(e.count for e in kernels)} kernel "
          f"launches; device idle share {100 * (1 - busy_ms / wall_ms):.1f} %;"
          f" peak memory {peak_gb:.2f} GiB; fp32 weights cast at use: "
          f"{casts} tensors per microbatch forward")
    for e in kernels[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"{tag}   {ms:8.3f} ms {100 * ms / busy_ms:5.1f} % x{e.count:<5d} "
              f"{e.key[:100]}")
    for name in ("scores_", "gather_partial_kernel", "dk_sum_kernel",
                 "upsample_kernel", "adjoint_kernel", "gelu_bf16_kernel",
                 "gelu_bf16_bwd"):
        sel = [e for e in kernels if name in e.key]
        ms = sum(e.self_device_time_total for e in sel) / 1e3
        print(f"{tag} {name}: {ms:.3f} ms ({100 * ms / busy_ms:.1f} % of device"
              f" time), x{sum(e.count for e in sel)}")
    del model, opt, micro, loss_fn
    torch.cuda.empty_cache()
    return wall_ms, busy_ms, peak_gb


# ---------------------------------------------------------------- phase (i)
# sup_unsup_seg golden at 128x256 (tests/test_flagship_golden.py:118-154):
# a flipped near-tie guidance pixel moves depth near it, so depth is held
# by the share of pixels within tolerance, its median and its maximum
SEG_GOLDEN_HW = (128, 256)
SEG_LOGIT_TOL = dict(rtol=2e-3, atol=1e-3)
SEG_FLIPS_MAX = 0.005
SEG_UNSUP_AGREE_MIN = 0.995
SEG_DEPTH_SHARE_MIN = 0.995
# tpu_decoder golden at 128x256 (tests/test_tpu_decoder_golden.py:76-79)
TPU_GOLDEN_TOL = dict(rtol=5e-4, atol=5e-6)
# the report keys of cli test for a supervised seg preset
SEG_METRIC_KEYS = METRIC_KEYS + ("iou",)


# launches of one forward (attention, bicubic, bf16 GELU) of each variant
# chip_smoke drives, fixed from the architecture and not read from the
# model under test: 34 encoder blocks (depths 3/10/16/5); a bicubic in each
# parity Decoder stage, 5 in the depth decoder, 2 more in the seg branch,
# none in the TPUDecoder stages that replace depth_upsample_3/4 (and the
# seg branch's); a GELU in each MixFFN and each decoder ConvLayer (bf16
# only), 6 more ConvLayers in the seg branch
FORWARD_LAUNCHES = {
    (False, False): (34, 5, 53),  # base
    (True, False): (34, 7, 59),  # the seg presets
    (False, True): (34, 3, 53),  # base + tpu_decoder
}


def variant_counts(model_cfg):
    """(attention, bicubic, bf16 GELU) launches of one forward of the model
    for ``model_cfg`` (FORWARD_LAUNCHES at base's 34 encoder blocks, each
    block one attention and one GELU; no GELU kernel in fp32)."""
    use_seg = model_cfg.supervised_seg or model_cfg.unsupervised_seg
    n_attn, n_up, n_gelu = FORWARD_LAUNCHES[use_seg, model_cfg.tpu_decoder]
    cut = n_attn - sum(model_cfg.depths)
    n_attn, n_gelu = n_attn - cut, n_gelu - cut
    return n_attn, n_up, (n_gelu if model_cfg.compute_dtype == "bfloat16"
                          else 0)


def load_golden(name):
    from camradepth_tpu_torch.interop.golden import shapes_from_json

    with np.load(ROOT / "tests" / "goldens" / name) as z:
        golden = {k: z[k] for k in z.files if k != "shapes_json"}
        shapes = shapes_from_json(bytes(z["shapes_json"]).decode())
    return golden, shapes


def golden_forward(model_cfg, state_dict, counters, reset_counters, tag):
    """The fp32 forward at 128x256 on the golden input; checks its
    launches."""
    from camradepth_tpu_torch.interop.golden import golden_input
    from camradepth_tpu_torch.models.camradepth import create_model

    model = create_model(model_cfg, device="cuda", state_dict=state_dict)
    x = torch.from_numpy(golden_input(model_cfg.img_size,
                                      model_cfg.input_channels)).cuda()
    reset_counters()
    with torch.inference_mode():
        out = model(x)
    torch.cuda.synchronize()
    launches = counters()
    n_attn, n_up, _ = variant_counts(model_cfg)
    want = (n_attn, n_up, 0, 0)
    print(f"(i1) {tag} fp32 forward at {model_cfg.img_size[0]}x"
          f"{model_cfg.img_size[1]}: launches (attention, upsample, conv, "
          f"gelu) {launches} (expected {want})")
    require(launches == want, (tag, launches, want))
    return out


def phase_i1(counters, reset_counters):
    """The two committed goldens of this slice's variants, fp32, TF32
    off."""
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.interop.flax_convert import (
        state_dict_from_flax,
    )
    from camradepth_tpu_torch.interop.golden import (
        synth_flax_params,
        synth_state_values,
    )

    golden, shapes = load_golden("flagship_seg_128x256.npz")
    mcfg = dataclasses.replace(preset("sup_unsup_seg").model,
                               img_size=SEG_GOLDEN_HW,
                               compute_dtype="float32")
    out = golden_forward(mcfg, synth_state_values(shapes), counters,
                         reset_counters, "sup_unsup_seg")
    seg = out["seg"]["final_seg"].cpu().numpy()
    cy, cx = golden["crop_yx"]
    crop = seg[:, cy:cy + 32, cx:cx + 64]
    err = np.abs(crop - golden["final_seg_crop"]).max()
    np.testing.assert_allclose(crop, golden["final_seg_crop"],
                               **SEG_LOGIT_TOL, err_msg="final_seg_crop")
    flips = float((seg.argmax(-1) != golden["final_seg_argmax"]).mean())
    unsup = float((out["seg"]["unsup_map"].cpu().numpy()
                   == golden["unsup_map"]).mean())
    got = out["depth"]["final_depth"].cpu().numpy()[0, ..., 0]
    want = golden["final_depth"][0, ..., 0]
    derr = np.abs(got - want)
    share = float((derr <= 5e-4 + 2e-3 * np.abs(want)).mean())
    print(f"(i1) sup_unsup_seg vs flagship_seg_128x256.npz: logit crop "
          f"max_abs_err={err:.3g} ({SEG_LOGIT_TOL}); argmax flips "
          f"{100 * flips:.3f} % (< {100 * SEG_FLIPS_MAX} %); unsup_map "
          f"agreement {unsup:.5f} (> {SEG_UNSUP_AGREE_MIN}); depth within "
          f"5e-4 + 2e-3|want| on {100 * share:.3f} % of pixels (> "
          f"{100 * SEG_DEPTH_SHARE_MIN} %), median error "
          f"{np.median(derr):.3g} (< 2e-4), max {derr.max():.3g} (< 0.2)")
    require(flips < SEG_FLIPS_MAX, ("seg argmax flips", flips))
    require(unsup > SEG_UNSUP_AGREE_MIN, ("unsup_map agreement", unsup))
    require(share > SEG_DEPTH_SHARE_MIN and np.median(derr) < 2e-4
            and derr.max() < 0.2, ("seg golden depth", share,
                                   np.median(derr), derr.max()))

    golden, shapes = load_golden("tpu_decoder_128x256.npz")
    mcfg = dataclasses.replace(preset("base").model, img_size=SEG_GOLDEN_HW,
                               compute_dtype="float32", tpu_decoder=True)
    out = golden_forward(mcfg, state_dict_from_flax(synth_flax_params(
        shapes)), counters, reset_counters, "base + tpu_decoder")
    d = out["depth"]
    for key, got in (("final_depth", d["final_depth"]),
                     ("inter_depth_3", d["intermediate_depths"][2]),
                     ("inter_depth_4", d["intermediate_depths"][3])):
        got = got.cpu().numpy()
        print(f"(i1) tpu_decoder {key} vs tpu_decoder_128x256.npz: "
              f"max_abs_err={np.abs(got - golden[key]).max():.3g} "
              f"({TPU_GOLDEN_TOL})")
        np.testing.assert_allclose(got, golden[key], **TPU_GOLDEN_TOL,
                                   err_msg=key)
    torch.cuda.empty_cache()


def forward_busy(model, x):
    """Device busy ms and kernel launches of one forward of ``model`` (a
    model or a serving forward; torch.profiler, after one forward outside
    it)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    kernels = device_kernels(prof)
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels))


def stream(engine, frames, n_batches):
    """frames/s and ms per batch of ``n_batches`` batches streamed through
    ``engine`` (no profiler)."""
    engine.reset_stats()
    results = list(engine.infer_stream(
        frames[i % len(frames)] for i in range(n_batches * BATCH)))
    stats = engine.stats()
    return results, stats, 1e3 * stats["elapsed_s"] / stats["batches"]


def phase_i2(seg_cfg, pth, counters, reset_counters):
    """bf16 serving of sup_unsup_seg at batch 8: labels, launches per
    forward, agreement with the fp32 forward, busy and idle shares."""
    from camradepth_tpu_torch.interop.flax_convert import (
        load_reference_checkpoint,
    )
    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.serving import load_engine

    m = seg_cfg.model
    h, w = m.img_size
    n_batches = 4
    frames = np.random.default_rng(12).standard_normal(
        (n_batches * BATCH, h, w, m.input_channels), dtype=np.float32)
    engine = load_engine(seg_cfg, str(pth), batch_size=BATCH, device="cuda")
    reset_counters()
    results, stats, batch_ms = stream(engine, frames, n_batches)
    launches = counters()
    n_attn, n_up, n_gelu = variant_counts(m)
    per = tuple(v / n_batches for v in launches)
    print(f"(i2) sup_unsup_seg bf16 engine, {len(results)} frames in "
          f"{n_batches} batches of {BATCH}: launches per forward "
          f"(attention, upsample, conv, gelu) {per} (expected "
          f"{(n_attn, n_up, 0, n_gelu)})")
    require(launches == (n_batches * n_attn, n_batches * n_up, 0,
                         n_batches * n_gelu), launches)
    for r in results:
        s = r["seg"]
        require(s.dtype == np.uint8 and s.shape == (h, w)
                and int(s.max()) < m.num_classes, (s.dtype, s.shape))
        require(np.isfinite(r["depth"]).all() and r["depth"].shape == (h, w),
                r["depth"].shape)
    # bf16 against the fp32 forward on the same weights, three frames
    picks = [0, len(frames) // 2, len(frames) - 1]
    ref = create_model(dataclasses.replace(m, compute_dtype="float32"),
                       device="cuda",
                       state_dict=load_reference_checkpoint(str(pth)))
    with torch.inference_mode():
        out = ref(torch.from_numpy(frames[picks]).cuda())
        depth = (seg_cfg.data.max_depth * (1.0 - out["depth"]["final_depth"]
                 [..., 0].clamp(0.0, 1.0))).cpu().numpy()
        labels = out["seg"]["final_seg"].argmax(-1).cpu().numpy()
    del ref, out
    for j, i in enumerate(picks):
        own = float(np.abs(results[i]["depth"] - depth[j]).mean())
        agree = float((results[i]["seg"] == labels[j]).mean())
        print(f"(i2) frame {i}: mean |bf16 - fp32| depth = {own:.4f} m "
              f"(tol {SERVE_MEAN_ABS_M}); bf16 labels agree with fp32 on "
              f"{100 * agree:.2f} % of pixels")
        require(own <= SERVE_MEAN_ABS_M, (i, own))
    busy_ms, n_kernels = forward_busy(engine.model,
                                      torch.from_numpy(frames[:BATCH]).cuda())
    print(f"(i2) profiled sup_unsup_seg bf16 batch-{BATCH} forward: device "
          f"busy {busy_ms:.2f} ms, {n_kernels} kernel launches; steady "
          f"stream {batch_ms:.2f} ms per batch, {stats['frames_per_sec']:.2f}"
          f" frames/s; device idle share "
          f"{100 * (1 - busy_ms / batch_ms):.1f} %")
    del engine
    torch.cuda.empty_cache()


def phase_i3(seg_cfg, split, head, pth, counters, reset_counters):
    """cli test --preset sup_unsup_seg: fp32 on the card against the CPU
    over (g)'s two frames (iou included), and bf16 frames/s."""
    common = ["--preset", "sup_unsup_seg", "--set", "data.mini_dataset=1",
              "--checkpoint", str(pth)]
    f32 = ["--set", "model.compute_dtype=float32", "--test-batch", "1"]
    reports = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra, device, split_path in (
                ("bf16", ["--test-batch", str(BATCH)], "cuda", split),
                ("fp32_head", f32, "cuda", head),
                ("cpu_fp32_head", f32, "cpu", head)):
            path = Path(tmp) / f"{name}.json"
            reset_counters()
            rc, out = run_cli(["test", "--split", str(split_path),
                               "--report-json", str(path), "--device",
                               device] + common + extra)
            torch.cuda.synchronize()
            launches = counters()
            require(rc == 0, (name, rc, out[-2000:]))
            report = json.loads(path.read_text())
            require(set(SEG_METRIC_KEYS) <= set(report)
                    and "IoU:" in out, (name, sorted(report)))
            require(all(np.isfinite(report[k]) for k in SEG_METRIC_KEYS),
                    (name, report))
            reports[name] = report
            print(f"(i3) cli test sup_unsup_seg {name}: frames="
                  f"{report['frames']:.0f} rmse_100="
                  f"{report['rmse_100']:.4f} iou={report['iou']:.5f} "
                  f"frames_per_sec_steady="
                  f"{report.get('frames_per_sec_steady', float('nan')):.2f}"
                  f"; launches {launches}")
            if name == "bf16":
                n_fwd = int(report["frames"]) // BATCH
                n_attn, n_up, n_gelu = variant_counts(seg_cfg.model)
                want = (n_fwd * n_attn, n_fwd * n_up, 0, n_fwd * n_gelu)
                require(launches == want, (launches, want))
    card, cpu = reports["fp32_head"], reports["cpu_fp32_head"]
    for k in SEG_METRIC_KEYS:
        require(abs(card[k] - cpu[k]) <= REPORT_RTOL * abs(cpu[k]),
                (k, card[k], cpu[k]))
    print(f"(i3) cli test sup_unsup_seg fp32 on the card = on the CPU over "
          f"{int(cpu['frames'])} frames, every metric and iou within rtol "
          f"{REPORT_RTOL} (iou {card['iou']:.6f} vs {cpu['iou']:.6f})")


def train_losses(run_dir):
    rows = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    return {tag: [r["value"] for r in rows if r["tag"] == tag]
            for tag in {r["tag"] for r in rows}}


def phase_i4(seg_cfg, split, all_counters, reset_counters):
    """cli train --preset sup_unsup_seg at 416x800 bf16, batch 2 x 3, one
    epoch of 4 steps on the 24/8 split; the best checkpoint serves depth
    and seg; one profiled step."""
    from camradepth_tpu_torch.serving import load_engine
    from camradepth_tpu_torch.utils.checkpoint import best_checkpoint

    h, w = seg_cfg.model.img_size
    n_train, n_val, accum = 24, 8, 3
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = Path(tmp) / "run"
        argv = ["train", "--preset", "sup_unsup_seg", "--split", str(split),
                "--train-val-split", f"{n_train},{n_val}", "--run-dir",
                str(run_dir), "--save-model", "--batch-size",
                str(TRAIN_BATCH), "--desired-batch-size",
                str(TRAIN_BATCH * accum), "--num-epochs", "1", "--set",
                "train.log_every=1"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.perf_counter()
        rc, out = run_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_counters()
        require(rc == 0, (rc, out[-2000:]))
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        steps = n_train // (TRAIN_BATCH * accum)
        micro, fwd = steps * accum, steps * accum + -(-n_val // TRAIN_BATCH)
        n_attn, n_up, n_gelu = variant_counts(seg_cfg.model)
        want = (fwd * n_attn, fwd * n_up, 0, fwd * n_gelu, micro * n_attn,
                micro * n_up, micro * n_gelu)
        print(f"(i4) cli train sup_unsup_seg 416x800 bf16 batch "
              f"{TRAIN_BATCH} x {accum}: {steps} optimizer steps + eval of "
              f"{n_val} frames in {wall:.1f} s; launches {launches} "
              f"(expected {want}: {n_attn} + {n_attn}, {n_up} + {n_up}, "
              f"{n_gelu} + {n_gelu} per microbatch, forwards only for eval)")
        require(launches == want, (launches, want))
        logs = train_losses(run_dir)
        losses = {k: v for k, v in logs.items()
                  if k.startswith("train/loss")}
        require(len(logs["train/loss"]) == steps
                and len(logs["val/loss"]) == 1, logs.get("train/loss"))
        require(all(np.isfinite(v) for vs in losses.values() for v in vs)
                and np.isfinite(logs["val/loss"][0]), losses)
        require(min(logs["train/loss_seg_final"]) > 0,
                logs["train/loss_seg_final"])
        best = best_checkpoint(run_dir)
        require(best is not None, "no best checkpoint written")
        print(f"(i4) train loss {[round(v, 6) for v in logs['train/loss']]},"
              f" loss_seg_final "
              f"{[round(v, 6) for v in logs['train/loss_seg_final']]}, val "
              f"loss {logs['val/loss'][0]:.6f}; steps_per_sec="
              f"{logs['train/steps_per_sec'][-1]:.3f}; peak memory "
              f"{peak_gb:.2f} GiB")
        engine = load_engine(seg_cfg, str(best), batch_size=TRAIN_BATCH,
                             device="cuda")
        res = engine.infer_batch(np.random.default_rng(6).standard_normal(
            (TRAIN_BATCH, h, w, seg_cfg.model.input_channels),
            dtype=np.float32))
        require(res["depth"].shape == (TRAIN_BATCH, h, w)
                and np.isfinite(res["depth"]).all(), res["depth"].shape)
        require(res["seg"].dtype == np.uint8
                and res["seg"].shape == (TRAIN_BATCH, h, w), res["seg"].shape)
        print(f"(i4) load_engine served {TRAIN_BATCH} frames from "
              f"{best.name}: depth and uint8 labels "
              f"{int(res['seg'].min())}..{int(res['seg'].max())}")
        del engine
    profile_train_step(seg_cfg, accum, tag="(i4)")


def phase_i5(split, counters, reset_counters):
    """base vs base + tpu_decoder, bf16 batch-8 forward at 416x800 in turns
    (parity, variant, variant, parity); then 2 cli train --tpu-decoder
    steps."""
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.serving import DepthEngine

    cfg = preset("base")
    variants = {"parity": cfg, "tpu_decoder": cfg.replace(
        model=dataclasses.replace(cfg.model, tpu_decoder=True))}
    h, w = cfg.model.img_size
    n_batches = 4
    frames = np.random.default_rng(13).standard_normal(
        (n_batches * BATCH, h, w, 7), dtype=np.float32)
    engines = {k: DepthEngine(c, create_model(c.model, device="cuda",
                                              seed=0), batch_size=BATCH,
                              device="cuda")
               for k, c in variants.items()}
    x = torch.from_numpy(frames[:BATCH]).cuda()
    for name in ("parity", "tpu_decoder", "tpu_decoder", "parity"):
        engine = engines[name]
        engine.warmup()
        reset_counters()
        _, stats, batch_ms = stream(engine, frames, n_batches)
        launches = counters()
        n_attn, n_up, n_gelu = variant_counts(variants[name].model)
        require(launches == (n_batches * n_attn, n_batches * n_up, 0,
                             n_batches * n_gelu), (name, launches))
        busy_ms, n_kernels = forward_busy(engine.model, x)
        print(f"(i5) {name}: bf16 batch-{BATCH} forward device busy "
              f"{busy_ms:.2f} ms ({n_kernels} kernels), steady stream "
              f"{batch_ms:.2f} ms per batch, {stats['frames_per_sec']:.2f} "
              f"frames/s; launches per forward (attention, upsample, conv, "
              f"gelu) {tuple(v // n_batches for v in launches)}")
    del engines, engine, x
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = Path(tmp) / "run"
        rc, out = run_cli(["train", "--preset", "base", "--tpu-decoder",
                           "--split", str(split), "--train-val-split",
                           "12,2", "--run-dir", str(run_dir),
                           "--batch-size", str(TRAIN_BATCH),
                           "--desired-batch-size", str(3 * TRAIN_BATCH),
                           "--num-epochs", "1", "--set",
                           "train.log_every=1"])
        require(rc == 0, (rc, out[-2000:]))
        logs = train_losses(run_dir)
        losses = logs["train/loss"]
        require(len(losses) == 2 and all(np.isfinite(losses))
                and np.isfinite(logs["val/loss"][0]), logs.get("train/loss"))
        print(f"(i5) cli train --tpu-decoder, 2 bf16 steps: losses "
              f"{[round(v, 6) for v in losses]}, val loss "
              f"{logs['val/loss'][0]:.6f}")


def phase_i(counters, all_counters, reset_counters):
    """This slice's paths: the seg presets and the tpu_decoder variant."""
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.data import synthetic
    from camradepth_tpu_torch.data.split import save_split
    from camradepth_tpu_torch.interop.golden import synth_state_values

    times = [time.perf_counter()]
    phase_i1(counters, reset_counters)
    times.append(time.perf_counter())
    seg_cfg = preset("sup_unsup_seg")
    h, w = seg_cfg.model.img_size
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _, shapes = load_golden("flagship_seg_128x256.npz")
        pth = tmp / "seg_synth.pth"
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                                   synth_state_values(shapes).items()}}, pth)
        split = synthetic.generate(tmp / "data", num_frames=32, hw=(h, w),
                                   seed=0, rain_every=4)
        rows = np.load(split)
        head = save_split(rows[CPU_FRAMES], tmp / "head_split.npy")
        test16 = save_split(rows[:16], tmp / "test16_split.npy")
        print(f"(i) 32-frame {h}x{w} corpus and the seg .pth written in "
              f"{time.perf_counter() - times[-1]:.1f} s")
        phase_i2(seg_cfg, pth, counters, reset_counters)
        times.append(time.perf_counter())
        phase_i3(seg_cfg, test16, head, pth, counters, reset_counters)
        times.append(time.perf_counter())
        phase_i4(seg_cfg, split, all_counters, reset_counters)
        times.append(time.perf_counter())
        phase_i5(split, counters, reset_counters)
        times.append(time.perf_counter())
    print("(i) phase seconds: " + ", ".join(
        f"(i{j + 1}) {b - a:.1f}" for j, (a, b) in
        enumerate(zip(times, times[1:]))))


# ---------------------------------------------------------------- phase (j)
# cli test --wire on against dense cli test, both fp32 with TF32 off: the
# decoded batches are the dense ones, so the reports agree to roundoff
WIRE_REPORT_RTOL = 1e-6


def phase_j1(cfg, split, pth, all_counters, reset_counters):
    """cli distill at 416x800 bf16: teacher base from the golden's
    weights, student base + tpu_decoder, batch 2 x 3, one epoch of 4 steps
    on the 24/8 split; its best checkpoint served; one profiled step."""
    from camradepth_tpu_torch.serving import load_engine
    from camradepth_tpu_torch.utils.checkpoint import best_checkpoint

    h, w = cfg.model.img_size
    n_train, n_val, accum = 24, 8, 3
    student_cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                        tpu_decoder=True))
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = Path(tmp) / "run"
        argv = ["distill", "--preset", "base", "--tpu-decoder",
                "--teacher-checkpoint", str(pth), "--split", str(split),
                "--train-val-split", f"{n_train},{n_val}", "--run-dir",
                str(run_dir), "--save-model", "--batch-size",
                str(TRAIN_BATCH), "--desired-batch-size",
                str(TRAIN_BATCH * accum), "--num-epochs", "1", "--set",
                "train.log_every=1"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.perf_counter()
        rc, out = run_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_counters()
        require(rc == 0, (rc, out[-2000:]))
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        n, m = DISTILL_WARM_START
        line = f"#### teacher warm start: {n}/{m} param tensors transferred"
        require(line in out, out[:2000])
        steps = n_train // (TRAIN_BATCH * accum)
        micro, evals = steps * accum, -(-n_val // TRAIN_BATCH)
        t_attn, t_up, t_gelu = variant_counts(cfg.model)
        s_attn, s_up, s_gelu = variant_counts(student_cfg.model)
        # per microbatch the teacher's forward, the student's forward and
        # its backward; eval runs the student's forward alone
        want = (micro * (t_attn + s_attn) + evals * s_attn,
                micro * (t_up + s_up) + evals * s_up, 0,
                micro * (t_gelu + s_gelu) + evals * s_gelu,
                micro * s_attn, micro * s_up, micro * s_gelu)
        print(f"(j1) cli distill base -> base + tpu_decoder 416x800 bf16 "
              f"batch {TRAIN_BATCH} x {accum}: {steps} optimizer steps + "
              f"eval of {n_val} frames in {wall:.1f} s; {line[5:]}; "
              f"launches {launches} (expected {want}: {t_attn} + {s_attn} + "
              f"{s_attn}, {t_up} + {s_up} + {s_up}, {t_gelu} + {s_gelu} + "
              f"{s_gelu} per microbatch, the student's forward only for "
              f"eval)")
        require(launches == want, (launches, want))
        logs = train_losses(run_dir)
        keys = ("train/loss", "train/loss_distill", "train/loss_gt")
        require(all(len(logs[k]) == steps for k in keys)
                and len(logs["val/loss"]) == 1, logs.get("train/loss"))
        require(all(np.isfinite(v) for k in keys for v in logs[k])
                and np.isfinite(logs["val/loss"][0]), logs)
        best = best_checkpoint(run_dir)
        require(best is not None, "no best checkpoint written")
        print(f"(j1) loss {[round(v, 6) for v in logs['train/loss']]}, "
              f"loss_distill "
              f"{[round(v, 6) for v in logs['train/loss_distill']]}, val "
              f"loss {logs['val/loss'][0]:.6f}; steps_per_sec="
              f"{logs['train/steps_per_sec'][-1]:.3f} (epoch, loader "
              f"included); peak memory {peak_gb:.2f} GiB")
        engine = load_engine(student_cfg, str(best), batch_size=TRAIN_BATCH,
                             device="cuda")
        res = engine.infer_batch(np.random.default_rng(7).standard_normal(
            (TRAIN_BATCH, h, w, 7), dtype=np.float32))
        require(res["depth"].shape == (TRAIN_BATCH, h, w)
                and np.isfinite(res["depth"]).all(), res["depth"].shape)
        print(f"(j1) load_engine --tpu-decoder served {TRAIN_BATCH} frames "
              f"from {best.name}: depth {res['depth'].min():.3f} .. "
              f"{res['depth'].max():.3f} m")
        del engine
    profile_train_step(student_cfg, accum, tag="(j1)", teacher_cfg=cfg)
    return launches


def phase_j2(cfg, split, head, pth, counters, reset_counters):
    """The wire paths, each against its dense run: the decoded batch, cli
    test (fp32), cli serve (bf16) and one bf16 cli train step."""
    from camradepth_tpu_torch.config import DataConfig
    from camradepth_tpu_torch.data.pipeline import make_loaders
    from camradepth_tpu_torch.data.wire import decode_wire_micro

    h, w = cfg.model.img_size
    data_cfg = DataConfig(image_dimension=(h, w), mini_dataset=True)
    # the first test batch of the head split, wire and dense
    packed, dense = (next(iter(make_loaders(
        data_cfg, BATCH, split_path=head, wire_eval=wire)["test"]))
        for wire in (True, False))
    sent = sum(v.nbytes for k, v in packed.items() if k != "index")
    dense_bytes = sum(dense[k].nbytes for k in ("features", "gt_depth",
                                                "seg", "seg_inter"))
    got = decode_wire_micro({k: torch.from_numpy(v).cuda()
                             for k, v in packed.items()})
    torch.cuda.synchronize()
    for k in ("features", "gt_depth", "seg", "seg_inter"):
        want = torch.from_numpy(dense[k])
        if want.is_floating_point():
            want = want + 0.0  # the codec's one canonicalization: -0 -> +0
        g = got[k].cpu()
        require(g.dtype == want.dtype and g.shape == want.shape, k)
        require(torch.equal(g.view(torch.int32), want.view(torch.int32)), k)
    print(f"(j2) wire batch of {BATCH} frames decoded on the card = the "
          f"dense batch bit for bit (features, gt_depth, seg, seg_inter; "
          f"-0.0 read as +0.0); {sent / BATCH / 2**20:.2f} MiB a frame on "
          f"the wire against {dense_bytes / BATCH / 2**20:.2f} dense "
          f"(gt {'sparse' if 'gt_val' in packed else 'dense'})")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        common = ["--preset", "base", "--set", "data.mini_dataset=1",
                  "--checkpoint", str(pth), "--split", str(head)]
        reports = {}
        for mode in ("off", "on"):
            path = tmp / f"test_{mode}.json"
            reset_counters()
            rc, out = run_cli(["test", "--wire", mode, "--report-json",
                               str(path), "--test-batch", str(BATCH),
                               "--set", "model.compute_dtype=float32"]
                              + common)
            require(rc == 0, (mode, rc, out[-2000:]))
            reports[mode] = json.loads(path.read_text())
        for k in METRIC_KEYS:
            a, b = reports["on"][k], reports["off"][k]
            require(abs(a - b) <= WIRE_REPORT_RTOL * abs(b), (k, a, b))
        print(f"(j2) cli test --wire on = dense cli test, fp32 over "
              f"{reports['on']['frames']:.0f} frames, every metric within "
              f"rtol {WIRE_REPORT_RTOL} (rmse_100 {reports['on']['rmse_100']}"
              f" vs {reports['off']['rmse_100']}); frames/s steady "
              f"{reports['on']['frames_per_sec_steady']:.2f} wire, "
              f"{reports['off']['frames_per_sec_steady']:.2f} dense")

        maps, fps = {}, {}
        for mode in ("off", "on"):
            out_dir = tmp / f"served_{mode}"
            reset_counters()
            rc, out = run_cli(["serve", "--wire", mode, "--out",
                               str(out_dir), "--serve-batch", str(BATCH)]
                              + common)
            torch.cuda.synchronize()
            launches = counters()
            require(rc == 0, (mode, rc, out[-2000:]))
            stats = json.loads(out.strip().splitlines()[-1])
            paths = sorted(out_dir.glob("*_depth.npy"))
            maps[mode] = np.stack([np.load(p) for p in paths])
            fps[mode] = stats["frames_per_sec"]
            want = per_forward(cfg, len(paths) // BATCH + 1)
            require(launches == want, (mode, launches, want))
        require(maps["on"].shape == maps["off"].shape
                and np.isfinite(maps["on"]).all(), maps["on"].shape)
        require(np.array_equal(maps["on"].view(np.int32),
                               maps["off"].view(np.int32)), "serve maps")
        print(f"(j2) cli serve --wire on = dense cli serve, bf16: "
              f"{len(maps['on'])} depth maps bit for bit; frames/s "
              f"{fps['on']:.2f} wire, {fps['off']:.2f} dense")

        losses = {}
        for mode in ("off", "on"):
            run_dir = tmp / f"train_{mode}"
            rc, out = run_cli(["train", "--preset", "base", "--wire", mode,
                               "--split", str(split), "--train-val-split",
                               "6,2", "--run-dir", str(run_dir),
                               "--batch-size", str(TRAIN_BATCH),
                               "--desired-batch-size", str(3 * TRAIN_BATCH),
                               "--num-epochs", "1", "--set",
                               "train.log_every=1"])
            require(rc == 0, (mode, rc, out[-2000:]))
            losses[mode] = train_losses(run_dir)["train/loss"]
        require(len(losses["on"]) == 1 and losses["on"] == losses["off"]
                and np.isfinite(losses["on"][0]), losses)
        print(f"(j2) cli train --wire on, one bf16 step of batch "
              f"{TRAIN_BATCH} x 3: loss {losses['on'][0]!r} = the dense "
              f"step's {losses['off'][0]!r}")


def phase_j(weights, all_counters, counters, reset_counters):
    """This slice's paths: cli distill and the compact wire format."""
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.data import synthetic
    from camradepth_tpu_torch.data.split import save_split

    cfg = preset("base")
    h, w = cfg.model.img_size
    times = [time.perf_counter()]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        split = synthetic.generate(tmp / "data", num_frames=32, hw=(h, w),
                                   seed=0, rain_every=4)
        head = save_split(np.load(split)[:16], tmp / "head_split.npy")
        pth = tmp / "base_synth.pth"
        torch.save({"state_dict": {k: torch.from_numpy(v)
                                   for k, v in weights.items()}}, pth)
        print(f"(j) 32-frame {h}x{w} corpus and the teacher .pth written in "
              f"{time.perf_counter() - times[-1]:.1f} s")
        launches = phase_j1(cfg, split, pth, all_counters, reset_counters)
        times.append(time.perf_counter())
        phase_j2(cfg, split, head, pth, counters, reset_counters)
        times.append(time.perf_counter())
    print("(j) phase seconds: " + ", ".join(
        f"(j{j + 1}) {b - a:.1f}" for j, (a, b) in
        enumerate(zip(times, times[1:]))))
    return launches


# ---------------------------------------------------------------- phase (k)
# an artifact against the live engine on the same frames, depth in metres
# (0..100 m): the same kernels and library calls in the same order, so bit
# for bit is expected; the limit is a hundredth of the bf16 serving limit
ARTIFACT_MAX_ABS_M = 1e-2
# cli test on an fp32 artifact against cli test on its checkpoint: the
# artifact's depth is decoded to metres and encoded back
ARTIFACT_REPORT_RTOL = 1e-6
# (k4): concurrent single-frame requests, and requests per client in the
# rate measurement
HTTP_CLIENTS = 8
HTTP_ROUNDS = 4


def forward_counts():
    """The forward kernels' launch counts (attention, upsample, conv,
    gelu) of this process: phase (k) runs parts of itself in worker
    processes, each with its own counts."""
    from camradepth_tpu_torch.ops.attention import maxpool_attention_scores
    from camradepth_tpu_torch.ops.conv_fused import conv3x3_fused
    from camradepth_tpu_torch.ops.gelu import gelu_bf16
    from camradepth_tpu_torch.ops.resize import upsample_bicubic_x2

    return tuple(fn.launches for fn in (
        maxpool_attention_scores, upsample_bicubic_x2, conv3x3_fused,
        gelu_bf16))


def counted(fn):
    """(fn(), the forward kernels' launches during the call)."""
    before = forward_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, tuple(a - b for a, b in zip(forward_counts(), before))


def k_frames(cfg, n, seed):
    h, w = cfg.model.img_size
    return np.random.default_rng(seed).standard_normal(
        (n, h, w, cfg.model.input_channels), dtype=np.float32)


def k_export(tag, argv, out):
    """``cli export --format artifact`` to ``out``: (header, seconds)."""
    from camradepth_tpu_torch.interop.export import read_header

    t0 = time.perf_counter()
    rc, text = run_cli(["export", "--format", "artifact", "--out", str(out)]
                       + argv)
    seconds = time.perf_counter() - t0
    require(rc == 0, (tag, rc, text))
    header, blob = read_header(str(out))
    return header, seconds, (f"{tag} cli export: {seconds:.1f} s, "
                             f"{blob / 2**20:.1f} MiB, header batch "
                             f"{header['batch_size']}, platforms "
                             f"{header['platforms']}")


# (k1)'s dynamic-batch tpu_decoder artifact: base's widths at one encoder
# block a stage (its export and load grow with the graph's nodes: 94 s and
# 35 s at base's 34 blocks on a slow host)
K_DYNAMIC_DEPTHS = (1, 1, 1, 1)


def k_job_tpu_dynamic(tmp):
    """(k1, worker) a bf16 base + tpu_decoder artifact with a dynamic
    batch (K_DYNAMIC_DEPTHS), exported on the card, served at batches 3
    and 8 against the live engine; 4, 3 and 23 launches per forward."""
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.interop.export import load_serving_artifact
    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.serving import DepthEngine

    cfg = preset("base")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, tpu_decoder=True, depths=K_DYNAMIC_DEPTHS))
    sd = create_model(cfg.model, device="cpu", seed=7,
                      train=True).state_dict()
    pth, art = Path(tmp) / "tpu_decoder.pth", Path(tmp) / "tpu_dyn.pt2"
    torch.save({"state_dict": sd}, pth)
    depths = ",".join(str(d) for d in K_DYNAMIC_DEPTHS)
    _, _, line = k_export("(k1) tpu_decoder bf16 dynamic batch", [
        "--tpu-decoder", "--checkpoint", str(pth), "--artifact-dtype",
        "bfloat16", "--dynamic-batch", "--set",
        f"model.depths={depths}"], art)
    lines = [line]
    t0 = time.perf_counter()
    call, header = load_serving_artifact(str(art), "cuda")
    lines.append(f"(k1) tpu_decoder artifact loaded on the card in "
                 f"{time.perf_counter() - t0:.1f} s")
    require(header["batch_size"] is None and header["tpu_decoder"], header)
    model = create_model(cfg.model, device="cuda", state_dict=sd)
    frames = k_frames(cfg, BATCH, 21)
    want_launches = variant_counts(cfg.model)
    want_launches = (*want_launches[:2], 0, want_launches[2])
    for n in (3, BATCH):
        # the live engine at the same batch: cuDNN picks its algorithms by
        # shape, and in bf16 another batch rounds otherwise
        live = DepthEngine(cfg, model, batch_size=n, device="cuda")
        x = torch.from_numpy(frames[:n]).cuda()
        call(x)  # the first call at a shape warms cuDNN up
        out, launches = counted(lambda: call(x)["depth"].cpu().numpy())
        want = live.infer_batch(frames[:n])["depth"]
        err = float(np.abs(out - want).max())
        lines.append(f"(k1) tpu_decoder artifact at batch {n}: launches "
                     f"{launches} (expected {want_launches}), max |artifact"
                     f" - live at batch {n}| = {err:.3g} m (limit "
                     f"{ARTIFACT_MAX_ABS_M}; bit for bit: "
                     f"{np.array_equal(out, want)})")
        require(out.shape == want.shape, (out.shape, want.shape))
        require(launches == want_launches, (n, launches))
        require(err <= ARTIFACT_MAX_ABS_M, (n, err))
    return lines


def k_golden(final):
    """The artifact's final depth (the model's inverse encoding, [1, H,
    W]) against tests/goldens/flagship_416x800.npz with phase (c)'s
    limits. The golden holds the depth head's raw output, which leaves [0,
    1] at a few pixels; the serving forward clips it to [0, 1] before it
    decodes, so the golden is clipped alike."""
    with np.load(ROOT / "tests" / "goldens" / "flagship_416x800.npz") as z:
        golden = {k: z[k] for k in ("crop_yx", "final_depth_crop",
                                    "final_depth_f16")}
    cy, cx = golden["crop_yx"]
    lines = []
    for name, got, ref, atol in (
            ("final_depth_crop", final[:, cy:cy + 64, cx:cx + 128],
             golden["final_depth_crop"], 5e-4),
            ("final_depth_f16", final,
             golden["final_depth_f16"].astype(np.float32), 1.5e-3)):
        ref = np.clip(ref.reshape(got.shape), 0.0, 1.0)
        lines.append(f"(k2) {name}: max_abs_err="
                     f"{np.abs(got - ref).max():.3g} (rtol 2e-3, atol "
                     f"{atol})")
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=atol,
                                   err_msg=name)
    return lines


def k_job_fp32_cpu(tmp, pth, head):
    """(k2, k3; worker) an fp32 base artifact exported on the CPU at
    416x800 serves on the card through the kernels, within the golden's
    limits; cli test on it equals cli test on the checkpoint."""
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.interop.golden import golden_input
    from camradepth_tpu_torch.serving import load_engine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = preset("base")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="float32"))
    art = Path(tmp) / "base_fp32_cpu.pt2"
    f32 = ["--set", "model.compute_dtype=float32"]
    header, _, line = k_export("(k2) fp32 on the CPU", [
        "--checkpoint", str(pth), "--device", "cpu", "--serve-batch", "2"]
        + f32, art)
    lines = [line]
    require(header["platforms"] == ["cpu", "cuda"], header)
    t0 = time.perf_counter()
    engine = load_engine(cfg, str(art), batch_size=2, device="cuda")
    lines.append(f"(k2) load_engine on the card with warm-up: "
                 f"{time.perf_counter() - t0:.1f} s")
    x = golden_input(cfg.model.img_size)
    out, launches = counted(lambda: engine.infer_batch(x)["depth"])
    want = (sum(cfg.model.depths), 5, 0, 0)
    require(launches == want, (launches, want))
    lines.append(f"(k2) fp32 artifact traced on the CPU, on the card: "
                 f"launches {launches} (expected {want})")
    lines += k_golden(1.0 - out / cfg.data.max_depth)
    del engine
    reports = []
    for ckpt in (art, pth):
        path = Path(tmp) / f"k3_{ckpt.stem}.json"
        rc, text = run_cli(["test", "--split", str(head), "--checkpoint",
                            str(ckpt), "--report-json", str(path),
                            "--test-batch", "2", "--set",
                            "data.mini_dataset=1"] + f32)
        require(rc == 0, (ckpt, rc, text))
        reports.append(json.loads(path.read_text()))
    got, want = reports
    for k in METRIC_KEYS:
        require(abs(got[k] - want[k]) <= ARTIFACT_REPORT_RTOL * abs(want[k]),
                (k, got[k], want[k]))
    lines.append(f"(k3) cli test on the fp32 artifact = cli test on the "
                 f"checkpoint over {got['frames']:.0f} frames, every metric "
                 f"within rtol {ARTIFACT_REPORT_RTOL} (rmse_100 "
                 f"{got['rmse_100']:.6f} vs {want['rmse_100']:.6f})")
    return lines


def k_job_serve(tmp, art, pth, split):
    """(k3, worker) cli serve on the bf16 artifact writes the checkpoint's
    depth maps; --wire on with an artifact is refused."""
    maps = []
    for ckpt in (art, pth):
        out_dir = Path(tmp) / f"served_{Path(ckpt).stem}"
        rc, text = run_cli(["serve", "--split", str(split), "--checkpoint",
                            str(ckpt), "--out", str(out_dir),
                            "--serve-batch", str(BATCH), "--set",
                            "data.mini_dataset=1"])
        require(rc == 0, (ckpt, rc, text))
        maps.append([np.load(p) for p in sorted(out_dir.glob("*_depth.npy"))])
        stats = json.loads(text.strip().splitlines()[-1])
    require(len(maps[0]) == len(maps[1]) > 0, [len(m) for m in maps])
    err = max(float(np.abs(a - b).max()) for a, b in zip(*maps))
    require(err <= ARTIFACT_MAX_ABS_M, err)
    rc, _ = run_cli(["serve", "--split", str(split), "--checkpoint",
                     str(art), "--wire", "on", "--set",
                     "data.mini_dataset=1"])
    require(rc == 2, rc)
    return [f"(k3) cli serve on the bf16 artifact: {len(maps[0])} depth maps,"
            f" max |artifact - checkpoint| = {err:.3g} m; (checkpoint run: "
            f"{stats['frames_per_sec']:.2f} frames/s); --wire on with an "
            f"artifact refused (exit 2)"]


def http_post(port, body: bytes, path="/v1/depth"):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        data = r.read()
        code = r.status
    return code, data, time.perf_counter() - t0


def npy_bytes(a) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def phase_k4(cfg, engine, pth, split):
    """start_server with the bf16 batch-8 artifact engine: concurrent
    single-frame requests coalesce and each answer is the engine's own for
    that frame; requests/s and latency; a wire engine over HTTP (data.
    wire_radar_cap) answers the dense engine's depth."""
    import threading

    from camradepth_tpu_torch.cli import http_wire_plan
    from camradepth_tpu_torch.data.pipeline import make_loaders
    from camradepth_tpu_torch.serving import SERVE_WIRE_KEYS, load_engine
    from camradepth_tpu_torch.serving_http import start_server

    frames = k_frames(cfg, HTTP_CLIENTS, 31)
    servers = []
    try:
        srv, _ = start_server(engine, cfg, "127.0.0.1", 0)
        servers.append(srv)
        port = srv.server_address[1]
        engine.reset_stats()
        barrier = threading.Barrier(HTTP_CLIENTS)

        def one(i):
            barrier.wait(timeout=300)
            return http_post(port, npy_bytes(frames[i]))

        with ThreadPoolExecutor(HTTP_CLIENTS) as pool:
            answers = list(pool.map(one, range(HTTP_CLIENTS)))
        batches = engine.stats()["batches"]
        for i, (code, body, _) in enumerate(answers):
            require(code == 200, (i, code))
            got = np.load(io.BytesIO(body))["depth"]
            want = engine.infer_batch(frames[i:i + 1])["depth"]
            require(np.array_equal(got, want),
                    (i, float(np.abs(got - want).max())))
        print(f"(k4) {HTTP_CLIENTS} concurrent single-frame POSTs served in "
              f"{batches:.0f} batch(es); each answer = infer_batch of its "
              f"frame, bit for bit")
        require(batches < HTTP_CLIENTS, batches)

        def client(i):
            return [http_post(port, npy_bytes(frames[i]))[2]
                    for _ in range(HTTP_ROUNDS)]

        t0 = time.perf_counter()
        with ThreadPoolExecutor(HTTP_CLIENTS) as pool:
            lat = np.concatenate(list(pool.map(client, range(HTTP_CLIENTS))))
        wall = time.perf_counter() - t0
        print(f"(k4) {HTTP_CLIENTS} clients x {HTTP_ROUNDS} requests: "
              f"{lat.size / wall:.2f} requests/s, latency p50 "
              f"{1e3 * np.percentile(lat, 50):.1f} ms, p95 "
              f"{1e3 * np.percentile(lat, 95):.1f} ms")

        # wire: the probed plan's radar cap as data.wire_radar_cap, as
        # `cli serve --http-port --wire on --set data.wire_radar_cap=N`
        data = dataclasses.replace(cfg.data, split_path=str(split),
                                   mini_dataset=1)
        wire_batch = next(iter(make_loaders(data, BATCH,
                                            wire_eval=True)["test"]))
        dense_batch = next(iter(make_loaders(data, BATCH)["test"]))
        cap = wire_batch["radar_idx"].shape[1]
        wcfg = cfg.replace(data=dataclasses.replace(
            data, wire_format="on", wire_radar_cap=cap))
        wengine = load_engine(wcfg, str(pth), batch_size=BATCH,
                              wire_plan=http_wire_plan(wcfg))
        wsrv, _ = start_server(wengine, wcfg, "127.0.0.1", 0)
        servers.append(wsrv)
        err = 0.0
        for i in range(4):
            req = {k: wire_batch[k][i] for k in SERVE_WIRE_KEYS}
            buf = io.BytesIO()
            np.savez(buf, **req)
            code_w, body_w, _ = http_post(wsrv.server_address[1],
                                          buf.getvalue())
            feats = dense_batch["features"][i, ..., :cfg.model.input_channels]
            code_d, body_d, _ = http_post(port, npy_bytes(feats))
            require(code_w == code_d == 200, (code_w, code_d))
            got = np.load(io.BytesIO(body_w))["depth"]
            want = np.load(io.BytesIO(body_d))["depth"]
            err = max(err, float(np.abs(got - want).max()))
        print(f"(k4) wire engine over HTTP (radar cap {cap}): 4 frames, max "
              f"|wire - dense| = {err:.3g} m (limit {ARTIFACT_MAX_ABS_M})")
        require(err <= ARTIFACT_MAX_ABS_M, err)
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
            srv._camradepth_aggregator.close()


def phase_k(weights, reset_counters, counters, keep):
    """This slice's path: the serving artifact (cli export, load_engine,
    cli test and cli serve on artifacts) and the HTTP front end. The
    exports and loads are Python-bound (torch.export traces and
    deserializes some 9,000 graph nodes), so three parts run in worker
    processes beside the main one. The bf16 artifact is copied into
    ``keep`` for (s); returns its path there."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.data import synthetic
    from camradepth_tpu_torch.data.split import save_split
    from camradepth_tpu_torch.serving import load_engine

    cfg = preset("base")
    h, w = cfg.model.img_size
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, ProcessPoolExecutor(
            3, mp_context=multiprocessing.get_context("spawn")) as pool:
        tmp = Path(tmp)
        # the longest part first; it needs neither corpus nor weights
        jobs = [pool.submit(k_job_tpu_dynamic, str(tmp))]
        split = synthetic.generate(tmp / "data", num_frames=BATCH, hw=(h, w),
                                   seed=0, rain_every=4)
        head = save_split(np.load(split)[:4], tmp / "head_split.npy")
        pth = tmp / "base_synth.pth"
        torch.save({"state_dict": {k: torch.from_numpy(v)
                                   for k, v in weights.items()}}, pth)
        jobs.append(pool.submit(k_job_fp32_cpu, str(tmp), pth, head))
        art = tmp / "base_bf16.pt2"
        header, export_s, line = k_export("(k1) base bf16 batch 8", [
            "--checkpoint", str(pth), "--artifact-dtype", "bfloat16",
            "--serve-batch", str(BATCH)], art)
        print(line)
        require(header["batch_size"] == BATCH
                and header["platforms"] == ["cuda", "cpu"], header)
        kept = Path(shutil.copy(art, keep / art.name))
        jobs.append(pool.submit(k_job_serve, str(tmp), art, pth, split))
        t0 = time.perf_counter()
        engine = load_engine(cfg, str(art), batch_size=BATCH)
        print(f"(k1) load_engine on the artifact with warm-up: "
              f"{time.perf_counter() - t0:.1f} s")
        live = load_engine(cfg, str(pth), batch_size=BATCH)
        frames = k_frames(cfg, BATCH, 23)
        reset_counters()
        got = engine.infer_batch(frames)["depth"]
        launches = counters()
        want_launches = per_forward(cfg, 1)
        want = live.infer_batch(frames)["depth"]
        err = float(np.abs(got - want).max())
        print(f"(k1) artifact forward: launches (attention, upsample, "
              f"conv, gelu) {launches} (expected {want_launches}); max "
              f"|artifact - live| = {err:.3g} m (limit "
              f"{ARTIFACT_MAX_ABS_M}; bit for bit: "
              f"{np.array_equal(got, want)})")
        require(launches == want_launches, (launches, want_launches))
        require(err <= ARTIFACT_MAX_ABS_M, err)
        for job in jobs:
            for line in job.result():
                print(line)
        t_workers = time.perf_counter()
        # the two forwards with the card and the host to themselves (the
        # workers have ended): one profile each, the streams in turns
        x = torch.from_numpy(frames).cuda()
        for name, e in (("artifact", engine), ("live", live)):
            busy_ms, n_kernels = forward_busy(e._fwd, x)
            print(f"(k1) {name}: bf16 batch-{BATCH} forward device busy "
                  f"{busy_ms:.2f} ms ({n_kernels} kernels)")
        for name, e in (("artifact", engine), ("live", live),
                        ("live", live), ("artifact", engine)):
            _, stats, batch_ms = stream(e, frames, 4)
            print(f"(k1) {name}: steady stream {batch_ms:.2f} ms per batch, "
                  f"{stats['frames_per_sec']:.2f} frames/s")
        del live, x
        torch.cuda.empty_cache()
        t_turns = time.perf_counter()
        phase_k4(cfg, engine, pth, split)
    print(f"(k) phase seconds: (k1)-(k3) {t_workers - t_start:.1f} (main "
          f"export {export_s:.1f}), turns {t_turns - t_workers:.1f}, (k4) "
          f"{time.perf_counter() - t_turns:.1f}")
    return kept


# ---------------------------------------------------------------- phase (l)

# frames a loader pass reads: the 32-frame corpus of (g) twice
LOADER_FRAMES = 64
# frames of the one-thread timings
ONE_THREAD_FRAMES = 16


def same_example(got, want) -> bool:
    """Two loader examples hold the same keys, dtypes, shapes and bytes."""
    return got.keys() == want.keys() and all(
        got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        and got[k].tobytes() == want[k].tobytes() for k in want)


def phase_l1(data_cfg, rows, plan):
    """Every frame of the corpus, dense and wire, through the native host
    code and through numpy: bit for bit, and native by the counts."""
    import os
    import platform

    from camradepth_tpu_torch import native
    from camradepth_tpu_torch.data import channels, wire
    from camradepth_tpu_torch.data.pipeline import load_frame_arrays

    require(data_cfg.native_assemble, "the default config is not native")
    np_cfg = dataclasses.replace(data_cfg, native_assemble=False)
    native.library()  # built in (a)
    info = native.build_info
    print(f"(l1) host: {info['gxx']}; {platform.machine()}; "
          f"{len(os.sched_getaffinity(0))} CPUs for this process; native "
          f"library built in {info['seconds']:.2f} s ({info['path']})")
    native.reset_counts()
    for row in rows:
        arrays = load_frame_arrays(row, data_cfg)
        for name, fn, plan_arg in (("dense", channels.assemble_frame, ()),
                                   ("wire", wire.encode_frame_wire,
                                    (plan,))):
            got = fn(arrays, data_cfg, *plan_arg)
            want = fn(arrays, np_cfg, *plan_arg)
            require(same_example(got, want), (name, row[0]))
    n = len(rows)
    want = {"assemble_native": n, "assemble_numpy": n, "wire_native": n,
            "wire_numpy": n}
    require(native.counts == want, (native.counts, want))
    print(f"(l1) {n} frames of {data_cfg.image_dimension[0]}x"
          f"{data_cfg.image_dimension[1]}, dense and wire (radar_cap "
          f"{plan.radar_cap}, gt_cap {plan.gt_cap}): native = numpy bit "
          f"for bit on every key; counts {native.counts}")


def loader_rate(rows, data_cfg, plan) -> float:
    """Frames/s of a BatchLoader (batch 8, the config's workers) over
    LOADER_FRAMES frames of ``rows``, with no model."""
    from camradepth_tpu_torch.data.pipeline import (
        BatchLoader,
        NuscenesFrames,
    )

    loader = BatchLoader(NuscenesFrames(rows, data_cfg, wire_plan=plan),
                         BATCH, num_workers=data_cfg.num_workers,
                         prefetch=data_cfg.prefetch)
    n = 0
    t0 = time.perf_counter()
    while n < LOADER_FRAMES:
        for batch in loader:
            n += int(batch["valid"].sum())
    return n / (time.perf_counter() - t0)


def phase_l2(data_cfg, rows, plan):
    """The loader alone, dense and wire, numpy and native in turns; then
    one thread's ms per frame of each step."""
    from camradepth_tpu_torch.data import channels, wire
    from camradepth_tpu_torch.data.pipeline import load_frame_arrays

    cfgs = {"native": data_cfg,
            "numpy": dataclasses.replace(data_cfg, native_assemble=False)}
    rates: dict = {}
    for turn in ("numpy", "native", "native", "numpy"):
        for kind, p in (("dense", None), ("wire", plan)):
            rate = loader_rate(rows, cfgs[turn], p)
            rates.setdefault((kind, turn), []).append(rate)
            print(f"(l2) loader alone, {kind} {turn}: {rate:.2f} frames/s "
                  f"(batch {BATCH}, {data_cfg.num_workers} workers)")
    for (kind, turn), r in sorted(rates.items()):
        print(f"(l2) loader alone, {kind} {turn}: "
              + ", ".join(f"{v:.2f}" for v in r) + " frames/s in turns")

    steps = {"load_frame_arrays": [], "assemble native": [],
             "assemble numpy": [], "wire native": [], "wire numpy": []}
    for row in rows[:ONE_THREAD_FRAMES]:
        t0 = time.perf_counter()
        arrays = load_frame_arrays(row, data_cfg)
        steps["load_frame_arrays"].append(time.perf_counter() - t0)
        for turn, c in cfgs.items():
            t0 = time.perf_counter()
            channels.assemble_frame(arrays, c)
            t1 = time.perf_counter()
            wire.encode_frame_wire(arrays, c, plan)
            steps[f"assemble {turn}"].append(t1 - t0)
            steps[f"wire {turn}"].append(time.perf_counter() - t1)
    print("(l2) one thread, median ms per frame over "
          f"{ONE_THREAD_FRAMES} frames: " + ", ".join(
              f"{k} {1e3 * float(np.median(v)):.2f}"
              for k, v in steps.items()))


def phase_l3(cfg, split, pth, tmp, counters, reset_counters):
    """cli test and cli serve in bf16 at base 416x800, batch 8, native and
    numpy in turns: equal reports and maps, and the kernels' launches."""
    from camradepth_tpu_torch import native

    n_frames = len(np.load(split))
    common = ["--preset", "base", "--set", "data.mini_dataset=1",
              "--checkpoint", str(pth), "--split", str(split)]
    flags = {"native": [], "numpy": ["--set", "data.native_assemble=false"]}
    reports, served = {}, []
    for command in ("test", "serve"):
        for i, turn in enumerate(("native", "numpy", "numpy", "native")):
            out = tmp / f"l3_{command}_{i}"
            argv = [command] + common + flags[turn] + (
                ["--test-batch", str(BATCH), "--report-json",
                 str(out) + ".json"] if command == "test" else
                ["--serve-batch", str(BATCH), "--out", str(out)])
            reset_counters()
            native.reset_counts()
            rc, text = run_cli(argv)
            torch.cuda.synchronize()
            launches = counters()
            require(rc == 0, (command, turn, rc, text))
            # serve: and the engine's warm-up forward
            n_fwd = n_frames // BATCH + (command == "serve")
            require(launches == per_forward(cfg, n_fwd),
                    (command, turn, launches, per_forward(cfg, n_fwd)))
            want = {k: 0 for k in native.counts}
            want[f"assemble_{turn}"] = n_frames
            require(native.counts == want, (command, turn, native.counts))
            if command == "test":
                r = json.loads(Path(str(out) + ".json").read_text())
                reports.setdefault(turn, []).append(r)
                rate = (f"frames_per_sec_steady="
                        f"{r['frames_per_sec_steady']:.2f} "
                        f"frames_per_sec_end_to_end="
                        f"{r['frames_per_sec_end_to_end']:.2f}")
            else:
                stats = json.loads(text.strip().splitlines()[-1])
                maps = [np.load(out / f"{j:05d}_depth.npy")
                        for j in range(n_frames)]
                served.append(maps)
                require(all(a.tobytes() == b.tobytes()
                            for a, b in zip(maps, served[0])),
                        (turn, "served maps differ"))
                rate = (f"frames_per_sec={stats['frames_per_sec']:.2f} "
                        f"batch_ms_p50={stats['batch_ms_p50']:.2f}")
            print(f"(l3) cli {command} bf16 {turn}: {rate}; launches "
                  f"{launches} ({n_fwd} forwards of 34/5/53); assembled "
                  f"{n_frames} frames {turn}")
    first = reports["native"][0]
    for r in reports["native"] + reports["numpy"]:
        require(all(r[k] == first[k] for k in METRIC_KEYS),
                {k: (r[k], first[k]) for k in METRIC_KEYS})
    print(f"(l3) the 4 reports' metrics are equal (rmse_100 "
          f"{first['rmse_100']:.6f}) and the 4 runs' {n_frames} served "
          "maps bit for bit, native and numpy")


def phase_l(cfg, split, pth, tmp, counters, reset_counters):
    """This slice's path: the loader's native host code, on the 32-frame
    416x800 corpus of phase (g)."""
    from camradepth_tpu_torch.data import wire
    from camradepth_tpu_torch.data.split import load_split

    rows = load_split(split)
    plan = wire.plan_wire(rows, cfg.data)
    require(plan is not None, "the wire codec refused the corpus")
    t0 = time.perf_counter()
    phase_l1(cfg.data, rows, plan)
    t1 = time.perf_counter()
    phase_l2(cfg.data, rows, plan)
    t2 = time.perf_counter()
    phase_l3(cfg, split, pth, tmp, counters, reset_counters)
    print(f"(l) phase seconds: (l1) {t1 - t0:.1f}, (l2) {t2 - t1:.1f}, "
          f"(l3) {time.perf_counter() - t2:.1f}")


# ---------------------------------------------------------------- phase (m)
# (m1): one bf16 optimizer step of base at 416x800 under DDP and FSDP2 at
# world size 1 (NCCL) against the single-device step from the same weights,
# microbatches and dropout generators: the same kernels on the same values,
# so bit for bit is expected; the limit is relative L2 1e-6 per parameter
# and rtol 1e-6 for the losses and grad_norm
LAYOUT_REL = 1e-6
# (m3): parallel/gradcheck.py's CPU check on gloo ranks, (data, fsdp) of
# each group, held to tests/test_torch_parallel.py's limits
GLOO_LAYOUTS = ((2, 1), (1, 2), (2, 2))
GLOO_LIMITS = dict(loss_rel=1e-6, grad_rel=1e-5, params_rel=1e-5)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def full_params(model):
    """name -> a copy of the whole fp32 parameter (gathered from an FSDP2
    shard; no DDP prefix)."""
    from torch.distributed.tensor import DTensor

    from camradepth_tpu_torch.parallel.mesh import unwrap

    return {n: (p.full_tensor() if isinstance(p, DTensor) else p)
            .detach().clone() for n, p in unwrap(model).named_parameters()}


def resident_bytes(model, opt) -> int:
    """This rank's bytes of the parameters and the optimizer state."""
    from camradepth_tpu_torch.train.diffgrad import _local

    ts = [_local(p) for p in model.parameters()] + [
        _local(v) for s in opt.state.values() for v in s.values()
        if torch.is_tensor(v)]
    return sum(t.numel() * t.element_size() for t in ts)


def phase_m1(cfg, counters, reset_counters):
    """One bf16 step (batch 2 x 3) single-device, DDP and FSDP2 (the
    latter two built through Trainer(layout=...)) at world size 1: losses,
    grad_norm and parameters against the single-device step, the kernels'
    launches per microbatch, then step wall ms, device busy and peak
    memory of each in turns."""
    from torch.profiler import ProfilerActivity, profile

    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.parallel import multihost
    from camradepth_tpu_torch.parallel.mesh import Layout
    from camradepth_tpu_torch.train.diffgrad import DiffGradNorm
    from camradepth_tpu_torch.train.step import train_step
    from camradepth_tpu_torch.train.trainer import Trainer, step_generator

    accum, lr, t = cfg.train.update_interval, 1e-5, cfg.train
    t_start = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    tmp = tempfile.TemporaryDirectory()
    try:
        dev = torch.device("cuda")
        micro = [step_inputs(cfg, TRAIN_BATCH, 60 + j, "cuda")
                 for j in range(accum)]
        for mb in micro:
            mb["features"] = mb["features"].to(torch.bfloat16)
        model = create_model(cfg.model, device="cuda", seed=t.seed,
                             train=True)
        runs = {"single": (model, DiffGradNorm(
            model.parameters(), lr=lr, betas=t.betas, eps=t.eps,
            weight_decay=t.weight_decay))}
        for kind in ("ddp", "fsdp"):
            tr = Trainer(cfg, loaders={"train": [None] * accum},
                         run_dir=f"{tmp.name}/{kind}", device="cuda",
                         layout=Layout(1, 1, kind))
            runs[kind] = (tr.model, tr.optimizer)

        def step(kind, i):
            model, opt = runs[kind]
            gens = [step_generator(dev, t.seed, 0, i, j)
                    for j in range(accum)]
            return train_step(cfg, model, opt, micro, gens, lr)

        want_launches = per_microbatch(cfg, accum, 0)
        first = {}
        for kind in runs:
            torch.cuda.synchronize()
            reset_counters()
            metrics = step(kind, 0)
            torch.cuda.synchronize()
            launches = counters()
            require(launches == want_launches, (kind, launches,
                                                want_launches))
            first[kind] = ({k: float(v) for k, v in metrics.items()},
                           full_params(runs[kind][0]))
        (wm, wp) = first["single"]
        for kind in ("ddp", "fsdp"):
            gm, gp = first[kind]
            for k in ("loss", "loss_depth_final", "grad_norm"):
                require(abs(gm[k] - wm[k]) <= LAYOUT_REL * abs(wm[k]),
                        (kind, k, gm[k], wm[k]))
            rel = {n: ((gp[n] - w).double().norm()
                       / w.double().norm().clamp_min(1e-30)).item()
                   for n, w in wp.items()}
            worst = max(rel, key=rel.get)
            same = sum(torch.equal(gp[n], w) for n, w in wp.items())
            require(rel[worst] <= LAYOUT_REL, (kind, worst, rel[worst]))
            print(f"(m1) {kind} at world size 1 vs single-device, one bf16 "
                  f"step of base 416x800 (batch {TRAIN_BATCH} x {accum}): "
                  f"loss {gm['loss']!r} vs {wm['loss']!r}, grad_norm "
                  f"{gm['grad_norm']!r} vs {wm['grad_norm']!r}; parameters "
                  f"bit for bit {same}/{len(wp)}, largest relative L2 "
                  f"difference {rel[worst]:.3g} ({worst}; limit "
                  f"{LAYOUT_REL}); launches {want_launches} (34 + 34, 5 + 5"
                  f", 53 + 53 per microbatch)")
        del first, wp
        t_parity = time.perf_counter()
        # in turns: wall ms and peak memory of a step, then one profiled
        walls = {k: [] for k in runs}
        peaks = {}
        for i, kind in enumerate(("single", "ddp", "fsdp", "fsdp", "ddp",
                                  "single")):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            step(kind, 1 + i)
            torch.cuda.synchronize()
            walls[kind].append((time.perf_counter() - t0) * 1e3)
            peaks[kind] = (torch.cuda.max_memory_allocated() - before
                           + resident_bytes(*runs[kind])) / 2**30
        t_turns = time.perf_counter()
        for i, kind in enumerate(runs):
            # device activity only: the host's 80,000 launch records would
            # cost more than the step
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                step(kind, 7 + i)
                torch.cuda.synchronize()
            kernels = device_kernels(prof)
            busy = sum(e.self_device_time_total for e in kernels) / 1e3
            wall = sum(walls[kind]) / len(walls[kind])
            print(f"(m1) {kind}: step wall {wall:.2f} ms (mean of "
                  f"{', '.join(f'{w:.2f}' for w in walls[kind])}, in turns), "
                  f"device busy {busy:.2f} ms under the profiler "
                  f"({sum(e.count for e in kernels)} kernel launches), idle "
                  f"share {100 * (1 - busy / wall):.1f} %, peak memory "
                  f"{peaks[kind]:.2f} GiB (its parameters and optimizer "
                  f"state plus the step's peak above them)")
        print(f"(m1) seconds: set-up and the three first steps "
              f"{t_parity - t_start:.1f}, steps in turns "
              f"{t_turns - t_parity:.1f}, profiled steps "
              f"{time.perf_counter() - t_turns:.1f}")
    finally:
        multihost.shutdown()
        tmp.cleanup()


def phase_m2(cfg, split, counters, reset_counters):
    """cli train --coordinator at world size 1 (NCCL) for 2 optimizer
    steps on (g)'s corpus: finite losses, one checkpoint, served by
    load_engine, and the process group left."""
    from camradepth_tpu_torch.serving import load_engine

    h, w = cfg.model.img_size
    n_train, n_val, accum = 12, 4, 3
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = Path(tmp) / "run"
        argv = ["train", "--coordinator", f"127.0.0.1:{free_port()}",
                "--num-processes", "1", "--process-id", "0", "--preset",
                "base", "--split", str(split), "--train-val-split",
                f"{n_train},{n_val}", "--run-dir", str(run_dir),
                "--save-model", "--batch-size", str(TRAIN_BATCH),
                "--desired-batch-size", str(TRAIN_BATCH * accum),
                "--num-epochs", "1", "--set", "train.log_every=1"]
        reset_counters()
        t0 = time.perf_counter()
        rc, out = run_cli(argv)
        wall = time.perf_counter() - t0
        launches = counters()
        require(rc == 0, (rc, out[-2000:]))
        require(not torch.distributed.is_initialized(),
                "cli train left its process group running")
        steps = n_train // (TRAIN_BATCH * accum)
        want = per_microbatch(cfg, steps * accum, -(-n_val // TRAIN_BATCH))
        require(launches == want, (launches, want))
        rows = [json.loads(line) for line in
                (run_dir / "metrics.jsonl").read_text().splitlines()]
        losses = [r["value"] for r in rows if r["tag"] == "train/loss"]
        require(len(losses) == steps and all(np.isfinite(losses)), losses)
        ckpts = sorted(run_dir.glob("ckpt_*"))
        require(len(ckpts) == 1, ckpts)
        engine = load_engine(cfg, str(ckpts[0]), batch_size=TRAIN_BATCH,
                             device="cuda")
        d = engine.infer_batch(np.random.default_rng(6).standard_normal(
            (TRAIN_BATCH, h, w, cfg.model.input_channels),
            dtype=np.float32))["depth"]
        require(d.shape == (TRAIN_BATCH, h, w) and np.isfinite(d).all(),
                d.shape)
        print(f"(m2) cli train --coordinator (1 process, NCCL): {steps} "
              f"optimizer steps + eval in {wall:.1f} s, losses "
              f"{[round(v, 6) for v in losses]}, launches {launches}; "
              f"{ckpts[0].name} served by load_engine: depth {d.min():.3f} "
              f".. {d.max():.3f} m")


def start_m3():
    """Start parallel/gradcheck.py's check of each gloo layout, one CPU
    process per rank (no card)."""
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for data, fsdp in GLOO_LAYOUTS:
        n, port = data * fsdp, free_port()
        for r in range(n):
            procs.append(((data, fsdp, r), subprocess.Popen(
                [sys.executable, "-m", "camradepth_tpu_torch.parallel."
                 "gradcheck", "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", str(n), "--process-id", str(r),
                 "--data", str(data), "--fsdp", str(fsdp)],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    return procs, time.perf_counter()


def finish_m3(procs, t0):
    reports = {}
    try:
        for key, p in procs:
            out, _ = p.communicate(timeout=900)
            require(p.returncode == 0, (key, out[-3000:]))
            line = [x for x in out.splitlines() if x.startswith("{")][-1]
            reports[key] = json.loads(line)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
    wall = time.perf_counter() - t0
    for data, fsdp in GLOO_LAYOUTS:
        ranks = [reports[(data, fsdp, r)] for r in range(data * fsdp)]
        for rep in ranks:
            require(rep["grad_parity"]["ok"], rep["grad_parity"])
            for case in ("step", "seg_step"):
                for k, lim in GLOO_LIMITS.items():
                    require(rep[case][k] <= lim, (data, fsdp, case, k,
                                                  rep[case][k]))
        for case in ("step", "seg_step"):
            require(all(r[case]["loss"] == ranks[0][case]["loss"]
                        and r[case]["grad_norm"] == ranks[0][case]
                        ["grad_norm"] for r in ranks), (data, fsdp, case))
        r0 = ranks[0]
        print(f"(m3) gloo, {r0['layout']} ({data * fsdp} CPU processes): "
              f"grad_parity max rel {r0['grad_parity']['max_rel_diff']:.3g}"
              + "".join(
                  f"; {c}: loss rel {r0[c]['loss_rel']:.3g}, gradient rel "
                  f"L2 {r0[c]['grad_rel']:.3g}, parameters rel L2 "
                  f"{r0[c]['params_rel']:.3g}, largest change "
                  f"{r0[c]['param_max_change_lr']:.3g} lr"
                  for c in ("step", "seg_step"))
              + "; ranks bit for bit")
    print(f"(m3) the three gloo groups ({sum(a * b for a, b in GLOO_LAYOUTS)}"
          f" processes at once) took {wall:.1f} s of wall time. NCCL refuses "
          "two ranks on one card, so a run of two or more ranks on cards "
          "waits for a machine with more than one")


def phase_m(cfg, split, all_counters, reset_counters):
    """This slice's path: multi-device training."""
    t0 = time.perf_counter()
    phase_m1(cfg, all_counters, reset_counters)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    procs, t_m3 = start_m3()  # CPU processes beside (m2) on the card
    phase_m2(cfg, split, all_counters, reset_counters)
    t2 = time.perf_counter()
    finish_m3(procs, t_m3)
    print(f"(m) phase seconds: (m1) {t1 - t0:.1f}, (m2) {t2 - t1:.1f}, "
          f"(m3, beside (m2)) {time.perf_counter() - t_m3:.1f}")


# ---------------------------------------------------------------- phase (n)
# (n1): the fp32 forward sharded over sp = 2 ranks against the single-process
# fp32 forward, TF32 off: GroupNorm's and the token mean's fp32 sums run in
# another order across the ranks. rtol 1e-4, atol 1e-4 of the map's largest
# magnitude (the depth heads' outputs cross zero); the fp32 engines on a
# mesh, depth in metres, alike
SP_FP32_RTOL = 1e-4
# the ranks of (n): two on the one card, over gloo
SP_RANKS = 2


@contextlib.contextmanager
def recorded_calls():
    """{kernel: [its inputs at each call]} of the three forward kernels
    during the enclosed forward, recorded where the model calls their
    wrappers (the wrappers themselves, which count their launches, are
    left as they are)."""
    from camradepth_tpu_torch.models import encoder, layers

    calls = {"attention": [], "bicubic": [], "gelu": []}
    saved = {(mod, name): getattr(mod, name) for mod, name in (
        (encoder, "maxpool_attention"), (layers, "upsample_bicubic_x2"),
        (layers, "gelu_for_dtype"), (encoder, "gelu_for_dtype"))}

    def attention(x, q, k, num_heads, scale):
        calls["attention"].append((q, k, num_heads, scale))
        return saved[encoder, "maxpool_attention"](x, q, k, num_heads, scale)

    def bicubic(x):
        calls["bicubic"].append((x,))
        return saved[layers, "upsample_bicubic_x2"](x)

    def gelu(x):
        if x.dtype == torch.bfloat16:  # the kernel's dtype
            calls["gelu"].append((x,))
        return saved[layers, "gelu_for_dtype"](x)

    for (mod, name), fn in zip(saved, (attention, bicubic, gelu, gelu)):
        setattr(mod, name, fn)
    try:
        yield calls
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def shard_kernels_vs_plain(calls):
    """Each recorded call's kernel against its plain version on the same
    shard-shaped inputs: {kernel: (calls, max abs error, shapes)}; the
    bicubic and GELU kernels bit for bit, the attention within
    ATTN_TOL."""
    from camradepth_tpu_torch.ops.attention import (
        maxpool_attention_scores,
        maxpool_attention_scores_reference,
    )
    from camradepth_tpu_torch.ops.gelu import gelu_bf16, gelu_bf16_reference
    from camradepth_tpu_torch.ops.resize import (
        upsample_bicubic_x2,
        upsample_bicubic_x2_reference,
    )

    out = {}
    with torch.inference_mode():
        for key, kernel, plain in (
                ("attention", maxpool_attention_scores,
                 maxpool_attention_scores_reference),
                ("bicubic", upsample_bicubic_x2,
                 upsample_bicubic_x2_reference),
                ("gelu", gelu_bf16, gelu_bf16_reference)):
            err, shapes = 0.0, set()
            for args in calls[key]:
                got, want = kernel(*args), plain(*args)
                if key == "attention":
                    torch.testing.assert_close(got, want, **ATTN_TOL)
                else:
                    require(same_bits(got, want), (key, args[0].shape))
                err = max(err, (got.float() - want.float()).abs().max()
                          .item())
                shapes.add(tuple(args[0].shape))
            out[key] = (len(calls[key]), err, sorted(shapes))
    torch.cuda.synchronize()
    return out


def n_rank(argv):
    """One rank of phase (n) (``chip_smoke.py --rank-n RANK WORLD PORT
    CLI_PORT TMP SPLIT PTH``): (n1) the fp32 golden forward on sp ranks,
    then fp32 batch-8 engines (``load_engine(mesh=...)``) with the frames'
    rows over sp and with the batch over data, (n2) a bf16 batch-8 engine
    on sp (launches, each kernel on its shard shapes against its plain
    version, single-frame latency), (n4) an HTTP server on rank 0 with the
    others following it, then (n3) `cli serve --spatial-parallel` and
    `--data-parallel` over (g)'s corpus. Rank 0 writes the gathered maps;
    every rank its report."""
    import threading

    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.interop.golden import golden_input
    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.parallel import multihost, spatial
    from camradepth_tpu_torch.parallel.mesh import ServingLayout, ServingMesh
    from camradepth_tpu_torch.serving import DepthEngine, load_engine
    from camradepth_tpu_torch.serving_http import (
        MeshLeader,
        follow,
        start_server,
    )

    rank, world = int(argv[0]), int(argv[1])
    port, cli_ports = int(argv[2]), [int(v) for v in argv[3].split(",")]
    tmp, split, pth = Path(argv[4]), argv[5], argv[6]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = preset("base")
    h = cfg.model.img_size[0]
    report, seconds = {}, {}
    t0 = time.perf_counter()
    # gloo when the ranks outnumber the cards (NCCL refuses two on one)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cuda")
    mesh = ServingMesh(ServingLayout(1, world), h)
    primary = rank == 0

    # (n1) fp32, the golden's input and weights
    model_cfg = dataclasses.replace(cfg.model, compute_dtype="float32")
    model = create_model(model_cfg, device="cuda",
                         state_dict=torch.load(pth)["state_dict"])
    x = torch.from_numpy(golden_input(model_cfg.img_size)).cuda()
    with torch.inference_mode(), spatial.sharded(mesh.rows):
        out, launches = counted(lambda: model(x[:, mesh.rows.rows(h)]))
        maps = {"final": out["depth"]["final_depth"],
                "inter2": out["depth"]["intermediate_depths"][2],
                "inter3": out["depth"]["intermediate_depths"][3]}
        maps = {k: mesh.gather(v) for k, v in maps.items()}
    if primary:
        for k, v in maps.items():
            np.save(tmp / f"n1_{k}.npy", v.numpy())
    report["n1_launches"] = launches
    del model, out, maps
    # fp32 engines on both axes: the rows of each frame, the batch's rows
    frames = np.load(tmp / "n_frames.npy")
    cfg32 = cfg.replace(model=model_cfg)
    for kind, layout in (("spatial", ServingLayout(1, world)),
                         ("data", ServingLayout(world, 1))):
        engine = load_engine(cfg32, pth, batch_size=BATCH, device="cuda",
                             mesh=ServingMesh(layout, h))
        res = engine.infer_batch(frames)
        if primary:
            np.save(tmp / f"n1_engine_{kind}.npy", res["depth"])
        del engine
        torch.cuda.empty_cache()
    seconds["n1"] = time.perf_counter() - t0

    # (n2) bf16 batch 8: launches, each kernel on its shard shapes
    t1 = time.perf_counter()
    engine = load_engine(cfg, pth, batch_size=BATCH, device="cuda",
                         mesh=mesh)
    with recorded_calls() as calls:
        res, launches = counted(lambda: engine.infer_batch(frames))
    report["n2_launches"] = launches
    if primary:
        np.save(tmp / "n2_depth.npy", res["depth"])
    report["n2_kernels"] = shard_kernels_vs_plain(calls)
    del calls
    one = DepthEngine(cfg, engine.model, batch_size=1, device="cuda",
                      mesh=mesh)
    one.warmup()
    lat = []
    for _ in range(5):
        s = time.perf_counter()
        one.infer_batch(frames[:1])
        lat.append((time.perf_counter() - s) * 1e3)
    report["n2_latency_ms"] = lat
    seconds["n2"] = time.perf_counter() - t1

    # (n4) HTTP on rank 0; the other ranks follow it
    t2 = time.perf_counter()
    if primary:
        leader = MeshLeader(engine)
        srv, _ = start_server(leader, cfg, "127.0.0.1", 0)
        try:
            engine.reset_stats()
            barrier = threading.Barrier(HTTP_CLIENTS)

            def one_post(i):
                barrier.wait(timeout=300)
                return http_post(srv.server_address[1], npy_bytes(frames[i]))

            with ThreadPoolExecutor(HTTP_CLIENTS) as pool:
                answers = list(pool.map(one_post, range(HTTP_CLIENTS)))
            report["n4_batches"] = engine.stats()["batches"]
        finally:
            srv.shutdown()
            srv.server_close()
            srv._camradepth_aggregator.close()
        equal = []
        for i, (code, body, _) in enumerate(answers):
            got = np.load(io.BytesIO(body))["depth"]
            want = leader.infer_batch(frames[i:i + 1])["depth"]
            equal.append(code == 200 and bool(np.array_equal(got, want)))
        report["n4_equal"] = equal
        leader.stop()
    else:
        follow(engine)
    del engine, one
    torch.cuda.empty_cache()
    multihost.shutdown()
    seconds["n4"] = time.perf_counter() - t2

    # (n3) cli serve on (g)'s corpus: sp over the ranks, then data
    for kind, cli_port in zip(("spatial", "data"), cli_ports):
        t3 = time.perf_counter()
        argv_cli = ["serve", "--coordinator", f"127.0.0.1:{cli_port}",
                    "--num-processes", str(world), "--process-id", str(rank),
                    f"--{kind}-parallel", str(world),
                    "--preset", "base", "--split", split, "--set",
                    "data.mini_dataset=1", "--checkpoint", pth, "--out",
                    str(tmp / f"n3_{kind}"), "--serve-batch", str(BATCH)]
        (rc, text), launches = counted(lambda: run_cli(argv_cli))
        report[f"n3_{kind}"] = {"rc": rc, "launches": launches,
                                "stats": text.strip().splitlines()[-1]
                                if primary and rc == 0 else text[-2000:]}
        seconds[f"n3_{kind}"] = time.perf_counter() - t3
    report["seconds"] = seconds
    (tmp / f"n_rank{rank}.json").write_text(json.dumps(report))
    print(f"[{rank}] DONE", flush=True)


def n_references(cfg, ref_model, engine, tmp):
    """The single-process references of (n), on the card before the ranks
    start: the fp32 golden forward; of (n2)'s frames the depth of the bf16
    engine, of a bf16 batch-4 engine (the witness of what another batch
    shape alone changes in bf16), of an fp32 batch-8 engine and of the
    fp32 forward; and the engine's single-frame latency."""
    from camradepth_tpu_torch.interop.golden import golden_input
    from camradepth_tpu_torch.serving import DepthEngine

    frames = k_frames(cfg, BATCH, 71)
    np.save(tmp / "n_frames.npy", frames)
    refs = {}
    x = torch.from_numpy(golden_input(cfg.model.img_size)).cuda()
    with torch.inference_mode():
        d = ref_model(x)["depth"]
        refs["n1"] = {"final": d["final_depth"].cpu().numpy(),
                      "inter2": d["intermediate_depths"][2].cpu().numpy(),
                      "inter3": d["intermediate_depths"][3].cpu().numpy()}
        d = ref_model(torch.from_numpy(frames).cuda())["depth"][
            "final_depth"][..., 0].clamp(0.0, 1.0)
        refs["fp32"] = (cfg.data.max_depth * (1.0 - d)).cpu().numpy()
    refs["bf16"] = engine.infer_batch(frames)["depth"]
    four = DepthEngine(cfg, engine.model, batch_size=BATCH // 2,
                       device="cuda")
    refs["bf16_b4"] = np.concatenate(
        [four.infer_batch(frames[i:i + BATCH // 2])["depth"]
         for i in range(0, BATCH, BATCH // 2)])
    cfg32 = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  compute_dtype="float32"))
    refs["fp32_engine"] = DepthEngine(cfg32, ref_model, batch_size=BATCH,
                                      device="cuda").infer_batch(frames)[
                                          "depth"]
    one = DepthEngine(cfg, engine.model, batch_size=1, device="cuda")
    one.warmup()
    lat = []
    for _ in range(5):
        s = time.perf_counter()
        one.infer_batch(frames[:1])
        lat.append((time.perf_counter() - s) * 1e3)
    refs["latency_ms"] = lat
    # the ranks share the card: hand back what the references cached
    del one, four
    torch.cuda.empty_cache()
    return refs


def phase_n(cfg, ref_model, engine, golden, split, pth, tmp,
            world=SP_RANKS):
    """This slice's path: spatial parallel and mesh serving on ``world``
    ranks (two on the one card over gloo; one card each over NCCL from
    tools/port_spatial_nccl.py), held to the single-process forward and
    served through cli serve and HTTP."""
    import os

    tmp = Path(tmp)
    t0 = time.perf_counter()
    refs = n_references(cfg, ref_model, engine, tmp)
    ports = [str(free_port()), f"{free_port()},{free_port()}"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-n", str(r),
         str(world), *ports, str(tmp), str(split), str(pth)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        require(p.returncode == 0 and f"[{r}] DONE" in log,
                (r, p.returncode, log[-4000:]))
    reports = [json.loads((tmp / f"n_rank{r}.json").read_text())
               for r in range(world)]
    t_ranks = time.perf_counter()
    where = (f"{world} ranks sharing one card over gloo"
             if world > torch.cuda.device_count()
             else f"{world} ranks on {world} cards over nccl")
    # (n1)
    fp32_want = (sum(cfg.model.depths), 5, 0, 0)
    per_bf16 = per_forward(cfg, 1)
    for r, rep in enumerate(reports):
        require(tuple(rep["n1_launches"]) == fp32_want,
                (r, rep["n1_launches"], fp32_want))
        require(tuple(rep["n2_launches"]) == per_bf16,
                (r, rep["n2_launches"], per_bf16))
    got = {k: np.load(tmp / f"n1_{k}.npy") for k in refs["n1"]}
    cy, cx = golden["crop_yx"]
    for name, g, ref, rtol, atol in (
            ("final_depth_crop", got["final"][:, cy:cy + 64, cx:cx + 128],
             golden["final_depth_crop"], 2e-3, 5e-4),
            ("final_depth_f16", got["final"],
             golden["final_depth_f16"].astype(np.float32), 2e-3, 1.5e-3),
            ("inter2", got["inter2"], golden["inter2"], 2e-3, 5e-4),
            ("inter3_f16", got["inter3"],
             golden["inter3_f16"].astype(np.float32), 2e-3, 1.5e-3)):
        np.testing.assert_allclose(g, ref, rtol=rtol, atol=atol,
                                   err_msg=f"(n1) {name}")
    for k, want in refs["n1"].items():
        err = np.abs(got[k] - want)
        np.testing.assert_allclose(
            got[k], want, rtol=SP_FP32_RTOL,
            atol=SP_FP32_RTOL * np.abs(want).max(), err_msg=f"(n1) {k}")
        print(f"(n1) fp32 sp {world} ({where}) vs single-process fp32, "
              f"{k}: max abs {err.max():.3g}, max rel "
              f"{(err / np.maximum(np.abs(want), 1e-30)).max():.3g} "
              f"(rtol {SP_FP32_RTOL}, atol {SP_FP32_RTOL} x max |map|)")
    print(f"(n1) the 416x800 golden's limits hold on the gathered maps; "
          f"launches per rank {[r['n1_launches'] for r in reports]} "
          f"(expected {fp32_want})")
    want = refs["fp32_engine"]
    for kind in ("spatial", "data"):
        got = np.load(tmp / f"n1_engine_{kind}.npy")
        err = np.abs(got - want)
        np.testing.assert_allclose(
            got, want, rtol=SP_FP32_RTOL,
            atol=SP_FP32_RTOL * np.abs(want).max(),
            err_msg=f"(n1) fp32 engine --{kind}-parallel")
        print(f"(n1) fp32 batch-{BATCH} engine --{kind}-parallel {world} "
              f"({where}) vs the single-process fp32 engine, depth in m: "
              f"max abs {err.max():.3g}, mean {err.mean():.3g}, "
              f"{np.mean(err == 0) * 100:.2f} % of pixels equal (rtol "
              f"{SP_FP32_RTOL}, atol {SP_FP32_RTOL} x max |map|)")
    # (n2)
    got = np.load(tmp / "n2_depth.npy")
    for i in range(BATCH):
        own = np.abs(got[i] - refs["fp32"][i]).mean()
        other = np.abs(got[i] - refs["fp32"][(i + 1) % BATCH]).mean()
        require(own <= SERVE_MEAN_ABS_M and own < 0.25 * other,
                (i, own, other))
    diff = np.abs(got - refs["bf16"])
    own = max(np.abs(got[i] - refs["fp32"][i]).mean() for i in range(BATCH))
    print(f"(n2) bf16 batch {BATCH} sp {world}: mean |sharded - fp32| per "
          f"frame <= {own:.4f} m "
          f"(tol {SERVE_MEAN_ABS_M}); against the single-process bf16 "
          f"engine mean {diff.mean():.4g} m, max {diff.max():.4g} m, "
          f"{np.mean(diff == 0) * 100:.2f} % of pixels equal; launches per "
          f"rank per forward {[r['n2_launches'] for r in reports]} "
          f"(expected {per_bf16})")
    diff = np.abs(refs["bf16_b4"] - refs["bf16"])
    print(f"(n2) witness, one process: the bf16 batch-{BATCH // 2} engine "
          f"against the bf16 batch-{BATCH} engine on the same frames: mean "
          f"{diff.mean():.4g} m, max {diff.max():.4g} m, "
          f"{np.mean(diff == 0) * 100:.2f} % of pixels equal")
    for r, rep in enumerate(reports):
        for key, (n, err, shapes) in rep["n2_kernels"].items():
            print(f"(n2) rank {r} {key} kernel = plain version on its "
                  f"{n} shard-shaped calls (max abs {err:.3g}; shapes "
                  f"{[tuple(s) for s in shapes][:6]}"
                  f"{' ...' if len(shapes) > 6 else ''})")
    lat_sp = [float(np.median(r["n2_latency_ms"])) for r in reports]
    print(f"(n2) single-frame latency (batch-1 engine, median of 5): "
          f"{lat_sp[0]:.1f} ms on {where} (not a scaling figure), "
          f"{np.median(refs['latency_ms']):.1f} ms on one process")
    # (n4)
    rep0 = reports[0]
    require(all(rep0["n4_equal"]) and len(rep0["n4_equal"]) == HTTP_CLIENTS,
            rep0["n4_equal"])
    require(rep0["n4_batches"] < HTTP_CLIENTS, rep0["n4_batches"])
    print(f"(n4) HTTP on sp {world}: {HTTP_CLIENTS} concurrent single-frame "
          f"POSTs served in {rep0['n4_batches']:.0f} batch(es); each answer "
          f"= infer_batch of its frame, bit for bit")
    # (n3)
    single = sorted((tmp / "served").glob("*_depth.npy"))
    require(len(single) == 32, len(single))
    for kind in ("spatial", "data"):
        for r, rep in enumerate(reports):
            run = rep[f"n3_{kind}"]
            require(run["rc"] == 0, (kind, r, run))
            # 4 batches of 8 and the warm-up, a (1/world) share of each
            require(tuple(run["launches"]) == per_forward(cfg, 5),
                    (kind, r, run["launches"]))
        maps = sorted((tmp / f"n3_{kind}").glob("*_depth.npy"))
        require([p.name for p in maps] == [p.name for p in single],
                (kind, len(maps)))
        worst, top, same = 0.0, 0.0, 0
        for g, w in zip(maps, single):
            d = np.abs(np.load(g) - np.load(w))
            worst, top = max(worst, d.mean()), max(top, d.max())
            same += int(d.max() == 0)
        require(worst <= SERVE_MEAN_ABS_M, (kind, worst))
        stats = json.loads(reports[0][f"n3_{kind}"]["stats"])
        print(f"(n3) cli serve --{kind}-parallel {world} ({where}): "
              f"{len(maps)} maps vs single-process cli serve: largest mean "
              f"|diff| per frame {worst:.4g} m (tol {SERVE_MEAN_ABS_M}), "
              f"max {top:.4g} m, {same}/{len(maps)} bit for bit; "
              f"frames_per_sec={stats['frames_per_sec']:.2f}; launches per "
              f"rank {reports[0][f'n3_{kind}']['launches']}")
    sec = reports[0]["seconds"]
    setup = t_ranks - t0 - sum(sec.values())
    print(f"(n) phase seconds: references {setup:.1f} and rank start-up, "
          + ", ".join(f"({k}) {v:.1f}" for k, v in sec.items())
          + f"; total {time.perf_counter() - t0:.1f}")


def n_corpus(cfg, weights, tmp):
    """(g)'s 32-frame corpus, its .pth and single-process `cli serve` maps
    (``tmp/served``), made again where (g) did not run."""
    from camradepth_tpu_torch.data import synthetic

    h, w = cfg.model.img_size
    split = synthetic.generate(tmp / "data", num_frames=32, hw=(h, w),
                               seed=0, rain_every=4)
    pth = tmp / "base_synth.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in weights.items()}}, pth)
    rc, out = run_cli(["serve", "--split", str(split), "--out",
                       str(tmp / "served"), "--limit", "32", "--serve-batch",
                       str(BATCH), "--preset", "base", "--set",
                       "data.mini_dataset=1", "--checkpoint", str(pth)])
    require(rc == 0, (rc, out))
    return split, pth


def phase_n_alone(worlds=(SP_RANKS,)):
    """(n) with what it needs from the earlier phases and nothing else:
    the kernels' build, the golden, the fp32 model of (c), a bf16 batch-8
    engine as (d)'s, and (g)'s corpus and maps (``python3 chip_smoke.py
    --phase n``; tools/port_spatial_nccl.py on several cards), once for
    each rank count of ``worlds``."""
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.ops import _build
    from camradepth_tpu_torch.serving import load_engine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_a()
    cfg = preset("base")
    golden, weights = golden_weights()
    ref_model = phase_c(cfg, golden, weights, forward_counts)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        split, pth = n_corpus(cfg, weights, tmp)
        engine = load_engine(cfg, str(pth), batch_size=BATCH, device="cuda")
        for world in worlds:
            run = tmp / f"ranks{world}"
            run.mkdir()
            (run / "served").symlink_to(tmp / "served")
            phase_n(cfg, ref_model, engine, golden, split, pth, run,
                    world=world)
            print(f"chip_smoke: phase (n) passed ({world} ranks; kernels "
                  f"in {_build.build_dir()})")


# ---------------------------------------------------------------- phase (o)
# (o1): one fp32 optimizer step of base at 416x800 (one microbatch of 2,
# dropout on, TF32 off) at sp = 2 against the single-process fp32 step from
# the same weights, microbatch and dropout generator, with remat off and
# on: the fp32 sums run in another order across the ranks through 34 blocks
# and the backward. Loss rtol 1e-5, each parameter's gradient relative L2
# the card-vs-CPU step limit
O_LOSS_RTOL = 1e-5
# the ranks of (o): two on the one card, over gloo, as (n)'s
O_SEED = 17
# (o2): cli train at sp = 2, bf16, batch 2 x 3, one optimizer step (6
# train frames) and eval of 4 frames; (o3): cli distill, one step
O_TRAIN, O_VAL, O_ACCUM = 6, 4, 3


def training_counts():
    """The training path's kernel launch counts of this process:
    (attention, upsample, gelu, attention backward, upsample backward,
    gelu backward)."""
    from camradepth_tpu_torch.ops.attention import (
        maxpool_attention_scores,
        maxpool_attention_scores_backward,
    )
    from camradepth_tpu_torch.ops.gelu import gelu_bf16, gelu_bf16_backward
    from camradepth_tpu_torch.ops.resize import (
        upsample_bicubic_x2,
        upsample_bicubic_x2_backward,
    )

    return tuple(fn.launches for fn in (
        maxpool_attention_scores, upsample_bicubic_x2, gelu_bf16,
        maxpool_attention_scores_backward, upsample_bicubic_x2_backward,
        gelu_bf16_backward))


def o_config(cfg, dtype, remat=False):
    return cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype=dtype, remat_encoder=remat,
        remat_decoder=remat))


@contextlib.contextmanager
def recorded_argmax(forced=None):
    """[the argmax [B, h, N] (int32, on the host) of each attention call]
    of the enclosed training step. With ``forced`` (such a list, the
    sharded step's, its ranks' tokens joined) each call takes the forced
    argmax instead, which may differ from its own only at near ties (the
    top two unscaled fp32 dots within ARGMAX_TIE x (1 + |max|)): both are
    then maxima, and the backward follows the sharded step's choice. The
    list then holds (rows that differ, the largest gap at one of them
    relative to 1 + |max|) per call."""
    from camradepth_tpu_torch.ops import attention

    out = []
    fn = attention.maxpool_attention_scores_with_argmax

    def recording(q, k, heads, scale):
        s, amax = fn(q, k, heads, scale)
        if forced is None:
            out.append(amax.cpu())
            return s, amax
        want = forced[len(out)].to(amax.device)
        diff = want != amax
        widest = 0.0
        if bool(diff.any()):
            with torch.no_grad():
                top2 = attention._dots(q, k, heads).topk(2, dim=-1).values
                rel = ((top2[..., 0] - top2[..., 1])
                       / (1 + top2[..., 0].abs()))[diff]
            widest = float(rel.max())
            require(widest <= ARGMAX_TIE, ("argmax differs off a tie",
                                           len(out), widest))
        out.append((int(diff.sum()), widest))
        return s, want

    attention.maxpool_attention_scores_with_argmax = recording
    try:
        yield out
    finally:
        attention.maxpool_attention_scores_with_argmax = fn


def o_step(cfg, model, micro, argmax=False, forced=None):
    """One optimizer step of ``model`` (wrapped for sp or not) on one
    microbatch, dropout drawn from a generator seeded with O_SEED: its
    metrics, every parameter's gradient (host copies), the launches and,
    with ``argmax`` or ``forced``, ``recorded_argmax``'s list."""
    from camradepth_tpu_torch.train.diffgrad import DiffGradNorm
    from camradepth_tpu_torch.train.step import train_step

    opt = DiffGradNorm(model.parameters(), lr=1e-3)
    gen = torch.Generator(device="cuda").manual_seed(O_SEED)
    torch.cuda.synchronize()
    before = training_counts()
    with (recorded_argmax(forced) if argmax or forced is not None
          else contextlib.nullcontext([])) as amax:
        metrics = train_step(cfg, model, opt, [micro], [gen], 1e-3)
        metrics = {k: float(v) for k, v in metrics.items()}
    launches = tuple(a - b for a, b in zip(training_counts(), before))
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    return metrics, grads, launches, amax


def o_microbatch(cfg, tmp):
    """(o1)'s microbatch of 2 (numpy, seeded): the GT of the second rank's
    rows at most 10 % valid, the first's ~60 % (``parity_microbatches``
    by image rows), written for the ranks."""
    from camradepth_tpu_torch.parallel.gradcheck import parity_microbatches

    micro = parity_microbatches(cfg, 1, TRAIN_BATCH, seed=O_SEED,
                                ranks=SP_RANKS, image_rows=True)[0]
    np.savez(tmp / "o_micro.npz", **micro)


def o_load_micro(tmp):
    return {k: torch.from_numpy(v).cuda()
            for k, v in np.load(tmp / "o_micro.npz").items()}


@contextlib.contextmanager
def recorded_training_calls():
    """{kernel: [(inputs, outputs) of each call]} of the training path's
    six kernels during the enclosed step, recorded at their autograd
    functions (the forwards' outputs, the backwards' saved inputs and
    cotangents); the wrappers, which count the launches, are untouched."""
    from camradepth_tpu_torch.ops import attention, gelu, resize

    calls = {k: [] for k in ("attention", "attention_bwd", "bicubic",
                             "bicubic_bwd", "gelu", "gelu_bwd")}
    saved = [(fn, name, getattr(fn, name)) for fn in (
        attention._Scores, resize._Upsample, gelu._GeluBf16)
        for name in ("forward", "backward")]

    def scores_fwd(q, k, heads, scale):
        s, amax = saved[0][2](q, k, heads, scale)
        calls["attention"].append(((q, k, heads, scale), s))
        return s, amax

    def scores_bwd(ctx, g, g_amax):
        out = saved[1][2](ctx, g, g_amax)
        q, k, amax = ctx.saved_tensors
        calls["attention_bwd"].append(((q, k, amax, g, ctx.num_heads,
                                        ctx.scale), out[:2]))
        return out

    def up_fwd(x):
        y = saved[2][2](x)
        calls["bicubic"].append(((x,), y))
        return y

    def up_bwd(ctx, gy):
        gx = saved[3][2](ctx, gy)
        calls["bicubic_bwd"].append(((gy,), gx))
        return gx

    def gelu_fwd(x):
        y = saved[4][2](x)
        calls["gelu"].append(((x,), y))
        return y

    def gelu_bwd(ctx, g):
        gx = saved[5][2](ctx, g)
        (x,) = ctx.saved_tensors
        calls["gelu_bwd"].append(((x, g), gx))
        return gx

    for (fn, name, _), new in zip(saved, (scores_fwd, scores_bwd, up_fwd,
                                          up_bwd, gelu_fwd, gelu_bwd)):
        setattr(fn, name, staticmethod(new))
    try:
        yield calls
    finally:
        for fn, name, old in saved:
            setattr(fn, name, staticmethod(old))


def training_kernels_vs_plain(calls):
    """Each recorded call's kernel output against its plain version on the
    same shard-shaped inputs: {kernel: (calls, max abs error, shapes)};
    attention within ATTN_TOL with the argmax equal off near ties, dq bit
    for bit and dk within 1 bf16 ulp (fp32: ATTN_BWD_TOL), the bicubic,
    its adjoint, the GELU and its VJP bit for bit."""
    from camradepth_tpu_torch.ops.attention import (
        maxpool_attention_scores_argmax_reference,
        maxpool_attention_scores_backward_reference,
    )
    from camradepth_tpu_torch.ops.gelu import (
        gelu_bf16_backward_reference,
        gelu_bf16_reference,
    )
    from camradepth_tpu_torch.ops.resize import (
        upsample_bicubic_x2_backward_reference,
        upsample_bicubic_x2_reference,
    )

    plain = {"bicubic": upsample_bicubic_x2_reference,
             "bicubic_bwd": upsample_bicubic_x2_backward_reference,
             "gelu": gelu_bf16_reference,
             "gelu_bwd": gelu_bf16_backward_reference}
    amax_of = {}
    for args, _ in calls["attention_bwd"]:
        amax_of[(args[0].data_ptr(), args[1].data_ptr())] = args[2]
    out = {}
    with torch.no_grad():
        for key, recs in calls.items():
            err, shapes, ties = 0.0, set(), 0
            for args, got in recs:
                if key == "attention":
                    q, k, heads, scale = args
                    want, want_amax = \
                        maxpool_attention_scores_argmax_reference(*args)
                    torch.testing.assert_close(got, want, **ATTN_TOL)
                    amax = amax_of[(q.data_ptr(), k.data_ptr())]
                    ties += argmax_near_ties(q, k, heads, amax)
                    e = (got - want).abs().max().item()
                elif key == "attention_bwd":
                    q = args[0]
                    wq, wk = maxpool_attention_scores_backward_reference(
                        *args)
                    require(torch.equal(got[0], wq), ("dq", q.shape))
                    if q.dtype == torch.bfloat16:
                        require(bf16_ulps(got[1], wk) <= 1.0, ("dk",
                                                               q.shape))
                    else:
                        torch.testing.assert_close(got[1], wk,
                                                   **ATTN_BWD_TOL)
                    e = (got[1].float() - wk.float()).abs().max().item()
                else:
                    want = plain[key](*args)
                    require(same_bits(got, want), (key, args[0].shape))
                    e = 0.0
                err = max(err, e)
                shapes.add(tuple(args[0].shape))
            out[key] = (len(recs), err, sorted(shapes), ties)
    torch.cuda.synchronize()
    return out


def o_recorders():
    """Record each step's and eval's metrics of the trainers in this
    process (floats), per call: {"train": [...], "val": [...]}."""
    from camradepth_tpu_torch.train.distill import DistillTrainer
    from camradepth_tpu_torch.train.trainer import Trainer

    rec = {"train": [], "val": []}
    for cls in (Trainer, DistillTrainer):
        step = cls.__dict__["_train_step"]

        def wrapped(self, micro, gens, lr, step=step):
            m = step(self, micro, gens, lr)
            rec["train"].append({k: float(v) for k, v in m.items()})
            return m

        cls._train_step = wrapped
    evaluate = Trainer.evaluate

    def wrapped_eval(self):
        m = evaluate(self)
        rec["val"].append(dict(m))
        return m

    Trainer.evaluate = wrapped_eval
    return rec


def o_rank(argv):
    """One rank of phase (o) (``chip_smoke.py --rank-o RANK WORLD PORT
    CLI_PORTS TMP SPLIT PTH``): (o1) the fp32 sp step with remat off and on
    (gradients to TMP from rank 0), a bf16 sp microbatch with every kernel
    call recorded and held to its plain version, and the profiled bf16 sp
    step; then (o2) `cli train --spatial-parallel` and (o3) `cli distill
    --spatial-parallel` over (g)'s corpus. Every rank writes its report."""
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.parallel import multihost
    from camradepth_tpu_torch.parallel.mesh import Layout, wrap

    rank, world = int(argv[0]), int(argv[1])
    port, cli_ports = int(argv[2]), [int(v) for v in argv[3].split(",")]
    tmp, split, pth = Path(argv[4]), argv[5], argv[6]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = preset("base")
    report, seconds = {}, {}
    t0 = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cuda")
    layout = Layout(sp=world)
    micro = o_load_micro(tmp)

    # (o1) fp32, remat off and on
    for remat in (False, True):
        c = o_config(cfg, "float32", remat)
        model = wrap(create_model(c.model, device="cuda", seed=O_SEED,
                                  train=True), layout)
        metrics, grads, launches, amax = o_step(c, model, micro,
                                                argmax=not remat)
        report[f"o1_remat{int(remat)}"] = {"metrics": metrics,
                                           "launches": launches}
        if rank == 0:
            torch.save(grads, tmp / f"o1_grads_remat{int(remat)}.pt")
        if amax:
            torch.save(amax, tmp / f"o1_amax{rank}.pt")
        del model, grads, amax
        torch.cuda.empty_cache()
    seconds["o1_fp32"] = time.perf_counter() - t0
    # (o1) bf16: each kernel call on its shard shapes
    t1 = time.perf_counter()
    c = o_config(cfg, "bfloat16")
    model = wrap(create_model(c.model, device="cuda", seed=O_SEED,
                              train=True), layout)
    micro16 = dict(micro, features=micro["features"].to(torch.bfloat16))
    with recorded_training_calls() as calls:
        metrics, _, launches, _ = o_step(c, model, micro16)
    report["o1_bf16"] = {"metrics": metrics, "launches": launches}
    report["o1_kernels"] = training_kernels_vs_plain(calls)
    del calls, model
    torch.cuda.empty_cache()
    # (o1)'s bf16 step ran these shapes: no warm-up step
    report["o1_profiled"] = profile_train_step(
        cfg, O_ACCUM, tag=f"(o) rank {rank}", layout=layout, top=0,
        warm=False)
    seconds["o1_bf16"] = time.perf_counter() - t1
    multihost.shutdown()

    # (o2) cli train, (o3) cli distill: sp over the ranks, in bf16
    rec = o_recorders()
    common = ["--coordinator", None, "--num-processes", str(world),
              "--process-id", str(rank), "--spatial-parallel", str(world),
              "--split", split, "--save-model", "--batch-size",
              str(TRAIN_BATCH), "--desired-batch-size",
              str(TRAIN_BATCH * O_ACCUM), "--num-epochs", "1", "--set",
              "train.log_every=1"]
    runs = (("o2", ["train", "--preset", "base", "--train-val-split",
                    f"{O_TRAIN},{O_VAL}"]),
            ("o3", ["distill", "--preset", "base", "--tpu-decoder",
                    "--teacher-checkpoint", pth, "--train-val-split",
                    f"{TRAIN_BATCH * O_ACCUM},{TRAIN_BATCH}"]))
    for (name, head), cli_port in zip(runs, cli_ports):
        t2 = time.perf_counter()
        argv_cli = head + ["--run-dir", str(tmp / f"{name}_run")] + [
            f"127.0.0.1:{cli_port}" if a is None else a for a in common]
        before = training_counts()
        rec["train"].clear()
        rec["val"].clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rc, text = run_cli(argv_cli)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t2
        report[name] = {
            "rc": rc, "out": text[-3000:], "wall_s": wall,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": tuple(a - b for a, b in zip(training_counts(),
                                                    before)),
            "train": list(rec["train"]), "val": list(rec["val"])}
        seconds[name] = wall
    report["seconds"] = seconds
    (tmp / f"o_rank{rank}.json").write_text(json.dumps(report))
    print(f"[{rank}] DONE", flush=True)


def o_reference(cfg, tmp, world):
    """(o1)'s single-process fp32 step (remat off) on the card once the
    ranks have ended, each attention call taking the sharded step's
    argmax where the two differ at a near tie (``recorded_argmax``)."""
    from camradepth_tpu_torch.models.camradepth import create_model

    ranks = [torch.load(tmp / f"o1_amax{r}.pt") for r in range(world)]
    forced = [torch.cat(calls, dim=-1) for calls in zip(*ranks)]
    c = o_config(cfg, "float32")
    model = create_model(c.model, device="cuda", seed=O_SEED, train=True)
    out = o_step(c, model, o_load_micro(tmp), forced=forced)
    del model
    torch.cuda.empty_cache()
    return out


def o_grad_errors(got, want):
    """Every parameter's gradient error, relative L2, largest first:
    [(error, name)]."""
    errs = []
    for name, w in want.items():
        g = got[name].double()
        w = w.double()
        errs.append((float((g - w).norm() / w.norm().clamp_min(1e-30)),
                     name))
    return sorted(errs, reverse=True)


def phase_o(cfg, split, pth, tmp, world=SP_RANKS):
    """This slice's path: spatially sharded training on ``world`` ranks
    (two on the one card over gloo), held to the single-process step and
    driven through cli train and cli distill."""
    import os

    from camradepth_tpu_torch.serving import load_engine
    from camradepth_tpu_torch.utils.checkpoint import best_checkpoint

    tmp = Path(tmp)
    t0 = time.perf_counter()
    o_microbatch(o_config(cfg, "float32"), tmp)
    single = [profile_train_step(cfg, O_ACCUM, tag="(o) single", top=0)]
    ports = [str(free_port()), f"{free_port()},{free_port()}"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t_refs = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-o", str(r),
         str(world), *ports, str(tmp), str(split), str(pth)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        require(p.returncode == 0 and f"[{r}] DONE" in log,
                (r, p.returncode, log[-4000:]))
    t_ranks = time.perf_counter()
    single.append(profile_train_step(cfg, O_ACCUM, tag="(o) single", top=0))
    ref_metrics, ref_grads, ref_launches, ties = o_reference(cfg, tmp, world)
    reports = [json.loads((tmp / f"o_rank{r}.json").read_text())
               for r in range(world)]
    where = (f"{world} ranks sharing one card over gloo"
             if world > torch.cuda.device_count()
             else f"{world} ranks on {world} cards over nccl")
    # (o1) fp32 against the single-process step
    n_attn = sum(cfg.model.depths)
    fp32_want = (n_attn, 5, 0, n_attn, 5, 0)
    require(ref_launches == fp32_want, (ref_launches, fp32_want))
    failed = []
    print(f"(o1) attention argmax, sp {world} against single-process (fp32, "
          f"remat off): {sum(n for n, _ in ties)} rows of {len(ties)} calls "
          f"differ, each a near tie (the top two single-process dots within "
          f"{max(w for _, w in ties):.3g} x (1 + |max|), tol {ARGMAX_TIE}), "
          "where the single-process step takes the sharded step's key")
    for remat in (0, 1):
        got = torch.load(tmp / f"o1_grads_remat{remat}.pt")
        errs = o_grad_errors(got, ref_grads)
        worst, name = errs[0]
        print(f"(o1) remat {'on' if remat else 'off'}: the worst parameters' "
              "gradient rel L2 " + ", ".join(f"{n} {e:.3g}"
                                             for e, n in errs[:8])
              + f"; {sum(e > STEP_GRAD_REL_L2 for e, _ in errs)} of "
              f"{len(errs)} past {STEP_GRAD_REL_L2}")
        for r, rep in enumerate(reports):
            m = rep[f"o1_remat{remat}"]["metrics"]
            for key in ("loss", "grad_norm"):
                rel = abs(m[key] - ref_metrics[key]) / abs(ref_metrics[key])
                require(rel <= (O_LOSS_RTOL if key == "loss"
                                else STEP_RTOL), (remat, r, key, rel))
            require(m == reports[0][f"o1_remat{remat}"]["metrics"],
                    ("ranks differ", remat, r))
        if worst > STEP_GRAD_REL_L2:
            failed.append(("(o1) gradient", remat, name, worst))
        m = reports[0][f"o1_remat{remat}"]["metrics"]
        print(f"(o1) fp32 sp {world} step of base 416x800 ({where}), remat "
              f"{'on' if remat else 'off'}: loss {m['loss']:.8g} vs "
              f"single-process {ref_metrics['loss']:.8g} (rel "
              f"{abs(m['loss'] - ref_metrics['loss']) / ref_metrics['loss']:.3g}"
              f", tol {O_LOSS_RTOL}); grad_norm rel "
              f"{abs(m['grad_norm'] - ref_metrics['grad_norm']) / ref_metrics['grad_norm']:.3g}"
              f"; worst parameter gradient rel L2 {worst:.3g} ({name}; tol "
              f"{STEP_GRAD_REL_L2}); launches per rank "
              f"{[r[f'o1_remat{remat}']['launches'] for r in reports]}; "
              "the ranks' metrics bit for bit")
    for r, rep in enumerate(reports):
        require(tuple(rep["o1_remat0"]["launches"]) == fp32_want,
                (r, rep["o1_remat0"]["launches"], fp32_want))
    # (o1) bf16 microbatch: launches and each kernel call
    bf16_want = per_microbatch(cfg, 1, 0)
    bf16_want = bf16_want[:2] + bf16_want[3:]  # no conv
    for r, rep in enumerate(reports):
        require(tuple(rep["o1_bf16"]["launches"]) == bf16_want,
                (r, rep["o1_bf16"]["launches"], bf16_want))
        for key, (n, err, shapes, ties) in rep["o1_kernels"].items():
            require(n > 0, (r, key))
            print(f"(o1) rank {r} {key} kernel = plain version on its {n} "
                  f"shard-shaped calls of a bf16 sp step (max abs "
                  f"{err:.3g}{f', {ties} near-tied argmax rows' if ties else ''}"
                  f"; shapes {[tuple(s) for s in shapes][:4]}"
                  f"{' ...' if len(shapes) > 4 else ''})")
    print(f"(o1) bf16 launches per rank per microbatch (attention, upsample, "
          f"gelu, their backwards) {[r['o1_bf16']['launches'] for r in reports]}"
          f" (expected {bf16_want}: one process's, 34 + 34, 5 + 5, 53 + 53)")
    for r, rep in enumerate(reports):
        wall, busy, peak = rep["o1_profiled"]
        print(f"(o1) profiled bf16 sp step (batch {TRAIN_BATCH} x {O_ACCUM}) "
              f"rank {r} ({where}): {wall:.2f} ms wall, device busy "
              f"{busy:.2f} ms, peak memory {peak:.2f} GiB")
    for i, (wall, busy, peak) in enumerate(single):
        print(f"(o1) profiled bf16 single-process step ({'before' if i == 0 else 'after'} "
              f"the ranks): {wall:.2f} ms wall, device busy {busy:.2f} ms, "
              f"peak memory {peak:.2f} GiB")
    # (o2) cli train
    for r, rep in enumerate(reports):
        run = rep["o2"]
        require(run["rc"] == 0, (r, run["out"]))
        require(len(run["train"]) == O_TRAIN // (TRAIN_BATCH * O_ACCUM)
                and len(run["val"]) == 1, (r, run["train"], run["val"]))
        require(run["train"] == reports[0]["o2"]["train"]
                and run["val"] == reports[0]["o2"]["val"], ("ranks", r))
        require(all(np.isfinite(m["loss"]) for m in run["train"] +
                    run["val"]), (r, run["train"], run["val"]))
        want = per_microbatch(cfg, len(run["train"]) * O_ACCUM,
                              -(-O_VAL // TRAIN_BATCH))
        want = want[:2] + want[3:]
        require(tuple(run["launches"]) == want, (r, run["launches"], want))
    best = best_checkpoint(tmp / "o2_run")
    require(best is not None, "(o2) no best checkpoint")
    engine = load_engine(cfg, str(best), batch_size=TRAIN_BATCH,
                         device="cuda")
    h, w = cfg.model.img_size
    d = engine.infer_batch(np.random.default_rng(6).standard_normal(
        (TRAIN_BATCH, h, w, cfg.model.input_channels),
        dtype=np.float32))["depth"]
    require(d.shape == (TRAIN_BATCH, h, w) and np.isfinite(d).all(), d.shape)
    del engine
    torch.cuda.empty_cache()
    r0 = reports[0]["o2"]
    print(f"(o2) cli train --spatial-parallel {world} ({where}), bf16 batch "
          f"{TRAIN_BATCH} x {O_ACCUM}: {len(r0['train'])} steps, losses "
          f"{[round(m['loss'], 6) for m in r0['train']]}, val loss "
          f"{r0['val'][0]['loss']:.6f}, the same bits on every rank; "
          f"launches per rank {[r['o2']['launches'] for r in reports]}; "
          f"best checkpoint {best.name} served by load_engine (depth "
          f"{d.min():.3f} .. {d.max():.3f} m)")
    for r, rep in enumerate(reports):
        print(f"(o2) rank {r}: {rep['o2']['wall_s']:.1f} s wall for the "
              f"command (start-up, loader and eval included), peak memory "
              f"{rep['o2']['peak_gib']:.2f} GiB")
    # (o3) cli distill
    for r, rep in enumerate(reports):
        run = rep["o3"]
        require(run["rc"] == 0, (r, run["out"]))
        require(len(run["train"]) == 1 and len(run["val"]) == 1,
                (r, run["train"], run["val"]))
        require(run["train"] == reports[0]["o3"]["train"], ("ranks", r))
        require(all(np.isfinite(v) for m in run["train"] + run["val"]
                    for v in m.values()), (r, run["train"]))
    warm = "teacher warm start: {}/{} param tensors".format(
        *DISTILL_WARM_START)
    require(warm in reports[0]["o3"]["out"], reports[0]["o3"]["out"])
    r0 = reports[0]["o3"]
    print(f"(o3) cli distill --spatial-parallel {world} ({where}), base into "
          f"base + tpu_decoder, bf16: {warm}; loss "
          f"{r0['train'][0]['loss']:.6f} (distill "
          f"{r0['train'][0]['loss_distill']:.6f}), val loss "
          f"{r0['val'][0]['loss']:.6f}; launches per rank "
          f"{[r['o3']['launches'] for r in reports]}; "
          f"{r0['wall_s']:.1f} s wall, peak {r0['peak_gib']:.2f} GiB (rank 0)")
    require(not failed, failed)
    sec = reports[0]["seconds"]
    print(f"(o) phase seconds: references {t_refs - t0:.1f}, ranks "
          f"{t_ranks - t_refs:.1f} ("
          + ", ".join(f"{k} {v:.1f}" for k, v in sec.items())
          + f"), total {time.perf_counter() - t0:.1f}")


def phase_o_alone(worlds=(SP_RANKS,)):
    """(o) with what it needs from the earlier phases and nothing else:
    the kernels' build, the golden's weights as a .pth and a 16-frame
    416x800 corpus (``python3 chip_smoke.py --phase o``;
    tools/port_spatial_nccl.py on several cards)."""
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.data import synthetic
    from camradepth_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_a()
    cfg = preset("base")
    _, weights = golden_weights()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        h, w = cfg.model.img_size
        split = synthetic.generate(tmp / "data", num_frames=O_TRAIN + O_VAL,
                                   hw=(h, w), seed=0, rain_every=4)
        pth = tmp / "base_synth.pth"
        torch.save({"state_dict": {k: torch.from_numpy(v)
                                   for k, v in weights.items()}}, pth)
        for world in worlds:
            run = tmp / f"ranks{world}"
            run.mkdir()
            phase_o(cfg, split, pth, run, world=world)
            print(f"chip_smoke: phase (o) passed ({world} ranks; kernels "
                  f"in {_build.build_dir()})")


# ---------------------------------------------------------------- phase (p)
# hyperparameter search with the trials vmapped through the kernels
P_TRIALS = 4
P_ACCUM = 3
P_TRAIN, P_VAL = 24, 8  # (g)'s 32-frame corpus, split as (h) splits it
# (p2): one fp32 vmapped step at 128x256 against three unvmapped steps on
# the card (the card-vs-CPU limits are (h)'s STEP_RTOL, STEP_GRAD_REL_L2)
P2_TRIALS = 3
P2_HW = (128, 256)
P2_LOSS_RTOL = 1e-5
P2_GRAD_REL_L2 = 1e-4
P2_LRS = (1e-4, 3e-4, 1e-3)
P2_WDS = (0.0, 1e-4, 1e-2)
# (p6): the trial axis over two ranks against one process (JAX's limit,
# tests/test_search_profiling.py:495-502)
P6_RTOL = 1e-5


def trial_fold(t):
    """[T, B, ...] -> [T*B, ...], the batch a vmap rule launches on."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


def randn_card(shape, seed, dtype):
    """N(0, 1) drawn on the card from a seeded generator (numpy's draw on
    the host takes seconds at (p1)'s sizes)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def equal_bits(got, want) -> bool:
    """Bit for bit in either dtype (bf16 NaNs as ``same_bits`` takes
    them)."""
    if got.dtype == torch.bfloat16:
        return same_bits(got, want)
    return torch.equal(got, want)


def phase_p1(cfg):
    """Each of the six kernel launch points under torch.func.vmap over
    P_TRIALS trials, at every shape of a base 416x800 batch-2 microbatch
    and a ragged one, bf16 and fp32: one launch per vmapped call, held to
    the plain version on the folded batch at (h)'s limits."""
    from camradepth_tpu_torch.ops import attention, gelu, resize

    vmap, t_n = torch.func.vmap, P_TRIALS
    m = cfg.model
    h, w = m.img_size
    b = TRAIN_BATCH
    attn = []
    for i in range(4):
        fh, fw = m.feature_shape(i)
        sr = m.sr_ratios[i]
        attn.append((b, fh * fw, (fh // sr) * (fw // sr), m.dims[i],
                     m.heads[i]))
    attn.append((3, 1001, 77, 120, 3))
    mid = m.mid_channels
    up = [(b, *m.feature_shape(3), m.dims[3]), (b, *m.feature_shape(2), mid),
          (b, *m.feature_shape(1), mid), (b, *m.feature_shape(0), mid + 1),
          (b, h // 2, w // 2, mid + 1), (3, 7, 9, 129)]
    gel = [(b,) + shape[1:] for shape, _ in gelu_forward_shapes(cfg)]
    gel.append((3, 5, 7, 13))
    wrappers = {"attention": attention.maxpool_attention_scores,
                "attention bwd": attention.maxpool_attention_scores_backward,
                "upsample": resize.upsample_bicubic_x2,
                "upsample bwd": resize.upsample_bicubic_x2_backward,
                "gelu": gelu.gelu_bf16, "gelu bwd": gelu.gelu_bf16_backward}
    calls = dict.fromkeys(wrappers, 0)

    def once(name, fn, *args):
        before = wrappers[name].launches
        out = vmap(fn)(*args)
        torch.cuda.synchronize()
        require(wrappers[name].launches == before + 1,
                (name, "vmapped call not one launch",
                 wrappers[name].launches - before))
        calls[name] += 1
        return out

    t0 = time.perf_counter()
    ties, dk_ulps, dk_err = 0, 0.0, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for seed, (bb, n, mm, c, heads) in enumerate(attn):
            q = randn_card((t_n, bb, n, c), 800 + seed, dtype)
            k = randn_card((t_n, bb, mm, c), 850 + seed, dtype)
            g = randn_card((t_n, bb, n), 900 + seed, torch.float32)
            scale = (c // heads) ** -0.5
            s, amax = once("attention", lambda a, kk: (
                attention.maxpool_attention_scores_with_argmax(
                    a, kk, heads, scale)), q, k)
            s0 = once("attention", lambda a, kk: (
                attention.maxpool_attention_scores(a, kk, heads, scale)),
                q, k)
            dq, dk = once("attention bwd", lambda a, kk, i, gg: (
                attention.maxpool_attention_scores_backward(
                    a, kk, i, gg, heads, scale)), q, k, amax, g)
            fq, fk, fa, fg = (trial_fold(x) for x in (q, k, amax, g))
            torch.testing.assert_close(
                trial_fold(s), attention.maxpool_attention_scores_reference(
                    fq, fk, heads, scale), **ATTN_TOL)
            require(torch.equal(s, s0), "argmax launch changed the scores")
            ties += argmax_near_ties(fq, fk, heads, fa)
            wq, wk = attention.maxpool_attention_scores_backward_reference(
                fq, fk, fa, fg, heads, scale)
            require(torch.equal(trial_fold(dq), wq), ("dq", n, c, dtype))
            if dtype == torch.bfloat16:
                ulps = bf16_ulps(trial_fold(dk), wk)
                require(ulps <= 1.0, ("dk", n, c, ulps))
                dk_ulps = max(dk_ulps, ulps)
            else:
                torch.testing.assert_close(trial_fold(dk), wk,
                                           **ATTN_BWD_TOL)
                dk_err = max(dk_err, (trial_fold(dk) - wk).abs().max()
                             .item())
        for seed, shape in enumerate(up):
            x = randn_card((t_n,) + shape, 950 + seed, dtype)
            y = once("upsample", resize.upsample_bicubic_x2, x)
            require(equal_bits(trial_fold(y),
                              resize.upsample_bicubic_x2_reference(
                                  trial_fold(x))), ("upsample", shape))
            bb, hh, ww, c = shape
            gy = randn_card((t_n, bb, 2 * hh, 2 * ww, c), 980 + seed, dtype)
            gx = once("upsample bwd", resize.upsample_bicubic_x2_backward, gy)
            require(equal_bits(trial_fold(gx),
                              resize.upsample_bicubic_x2_backward_reference(
                                  trial_fold(gy))), ("adjoint", shape))
        if dtype == torch.bfloat16:
            for seed, shape in enumerate(gel):
                x = randn_card((t_n,) + shape, 1000 + seed, dtype) * 3
                gy = randn_card((t_n,) + shape, 1050 + seed, dtype)
                y = once("gelu", gelu.gelu_bf16, x)
                require(same_bits(trial_fold(y), gelu.gelu_bf16_reference(
                    trial_fold(x))), ("gelu", shape))
                gx = once("gelu bwd", gelu.gelu_bf16_backward, x, gy)
                require(same_bits(trial_fold(gx),
                                  gelu.gelu_bf16_backward_reference(
                                      trial_fold(x), trial_fold(gy))),
                        ("gelu vjp", shape))
            del x, gy, y, gx
    print(f"(p1) the six launch points under torch.func.vmap over {t_n} "
          f"trials at every shape of a base 416x800 batch-{TRAIN_BATCH} "
          f"microbatch and a ragged one (bf16 and fp32; GELU bf16): vmapped "
          f"calls {calls}, each one launch; against the plain version on "
          f"the folded batch: attention scores within {ATTN_TOL}, argmax "
          f"equal off {ties} near ties (tol {ARGMAX_TIE}), dq bit for bit, "
          f"dk {dk_ulps:.2f} bf16 ulps (tol 1) and {dk_err:.3g} in fp32 "
          f"(tol {ATTN_BWD_TOL}); bicubic, its adjoint, GELU and its VJP "
          f"bit for bit; {time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def recorded_folded_argmax(folded):
    """[the argmax [T*B, h, N] (int32, host) of each attention call that a
    vmap rule folded to ``folded`` samples] of the enclosed vmapped step
    (the rule looks the operator up at each call)."""
    from camradepth_tpu_torch.ops import attention

    out = []
    op = attention.scores_argmax_op

    def recording(q, k, heads, scale):
        s, amax = op(q, k, heads, scale)
        if q.shape[0] == folded:  # the rule's call, outside the vmap
            out.append(amax.cpu())
        return s, amax

    attention.scores_argmax_op = recording
    try:
        yield out
    finally:
        attention.scores_argmax_op = op


def p2_config(cfg):
    mcfg = dataclasses.replace(cfg.model, img_size=P2_HW,
                               compute_dtype="float32", drop_path_rate=0.0,
                               dropout_rate=0.0)
    return cfg.replace(model=mcfg)


def p2_step(cfg, dev, argmax=None):
    """(p2)'s vmapped step on ``dev``: (losses, each trial's gradient with
    its weight decay, launches), and with ``argmax`` (a list) the folded
    argmax of every attention call recorded into it; on the card also
    (model, stacked initial params, the microbatch)."""
    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.train.search import _vmapped_machinery

    scfg = p2_config(cfg)
    t_n, b = P2_TRIALS, TRAIN_BATCH
    model = create_model(scfg.model, device=dev, seed=3, train=True)
    v_step, _, make_state = _vmapped_machinery(scfg, model, 3,
                                               torch.device(dev))
    micro = {k: v[None] for k, v in step_inputs(scfg, b, 31, dev).items()}
    params, opt = make_state(t_n)
    lrs = torch.tensor(P2_LRS, device=dev)
    wds = torch.tensor(P2_WDS, device=dev)
    card = dev == "cuda"
    with (recorded_folded_argmax(t_n * b) if card
          else contextlib.nullcontext([])) as amax:
        before = training_counts()
        _, opt1, losses = v_step(params, opt, lrs, wds, micro, [None], 0)
        if card:
            torch.cuda.synchronize()
        launches = tuple(a - c for a, c in zip(training_counts(), before))
    if argmax is not None:
        argmax.extend(amax)
    out = (losses.double().cpu(), {n: g.double().cpu() for n, g in
                                   opt1["previous_grad"].items()}, launches)
    return out + ((model, params, micro) if card else ())


def phase_p2(cfg, cpu_run):
    """One fp32 vmapped trial step (P2_TRIALS trials, base at 128x256, TF32
    off, dropout off): on the card against the port's CPU run of the same
    step (``cpu_run``, a future of ``p2_step`` on the CPU, run beside
    (p1)), and against one unvmapped step per trial on the card that takes
    the vmapped step's argmax where the two differ at a near tie."""
    from torch.func import functional_call, grad_and_value

    from camradepth_tpu_torch.train.losses import multitask_loss
    from camradepth_tpu_torch.train.step import build_gt

    scfg = p2_config(cfg)
    t_n, b = P2_TRIALS, TRAIN_BATCH
    t0 = time.perf_counter()
    # the CPU run first: the card run records at a module attribute the
    # CPU run's vmap rule would also reach
    lp, gp, _ = cpu_run.result()
    t_cpu = time.perf_counter() - t0
    amax = []
    lc, gc, launches, model, params, micro = p2_step(cfg, "cuda", amax)
    n_attn = sum(scfg.model.depths)
    require(launches == (n_attn, 5, 0, n_attn, 5, 0), launches)

    def rel(a, b_):
        return float((a - b_).norm() / b_.norm().clamp_min(1e-30))

    worst_cpu = max((rel(gc[n][t], gp[n][t]), t, n) for n in gp
                    for t in range(t_n))
    require(bool(((lc - lp).abs() <= STEP_RTOL * lp.abs()).all()),
            (lc, lp))
    require(worst_cpu[0] <= STEP_GRAD_REL_L2, worst_cpu)
    # one unvmapped step per trial on the card, the vmapped argmax forced
    mb = {k: v[0] for k, v in micro.items()}
    gt = build_gt(mb)

    def loss_fn(p):
        return multitask_loss(functional_call(model, p, (mb["features"],)),
                              gt, scfg)[0]

    worst, flips = (0.0, None, None), []
    for t in range(t_n):
        forced = [a[t * b:(t + 1) * b] for a in amax]
        p_t = {n: v[t] for n, v in params.items()}
        with recorded_argmax(forced) as diffs:
            g, loss = grad_and_value(loss_fn)(p_t)
        flips += diffs
        require(abs(loss.item() - lc[t].item())
                <= P2_LOSS_RTOL * abs(loss.item()), (t, loss.item(),
                                                     lc[t].item()))
        for n, v in g.items():
            want = (v + P2_WDS[t] * p_t[n]).double().cpu()
            worst = max(worst, (rel(gc[n][t], want), t, n))
    require(worst[0] <= P2_GRAD_REL_L2, worst)
    n_flip = sum(n for n, _ in flips)
    print(f"(p2) one fp32 vmapped step of base at {P2_HW[0]}x{P2_HW[1]}, "
          f"{t_n} trials x batch {b} (lr {P2_LRS}, wd {P2_WDS}), launches "
          f"{launches} (one call per layer for every trial): card vs CPU "
          f"losses {[round(v, 7) for v in lc.tolist()]} vs "
          f"{[round(v, 7) for v in lp.tolist()]} (rtol {STEP_RTOL}), worst "
          f"trial gradient relative L2 {worst_cpu[0]:.3g} (trial "
          f"{worst_cpu[1]}, {worst_cpu[2]}; tol {STEP_GRAD_REL_L2}); "
          f"against {t_n} unvmapped steps on the card: losses within rtol "
          f"{P2_LOSS_RTOL}, worst gradient {worst[0]:.3g} (trial {worst[1]},"
          f" {worst[2]}; tol {P2_GRAD_REL_L2}), {n_flip} argmax rows at near"
          f" ties forced to the vmapped keys (largest gap "
          f"{max([gap for _, gap in flips] + [0.0]):.3g}, tol {ARGMAX_TIE});"
          f" waited {t_cpu:.1f} s for the CPU run, "
          f"{time.perf_counter() - t0:.1f} s")
    del model, params, micro
    torch.cuda.empty_cache()


def search_argv(split, *extra):
    """cli search at base 416x800 bf16 on (g)'s corpus, batch 2 x 3."""
    return ["search", "--split", str(split), "--train-val-split",
            f"{P_TRAIN},{P_VAL}", "--batch-size", str(TRAIN_BATCH),
            "--desired-batch-size", str(TRAIN_BATCH * P_ACCUM), *extra]


def search_results(out):
    """(the result dicts, the best config's overrides) of cli search's
    printed lines."""
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    best = [ln for ln in out.splitlines() if ln.startswith("best config: ")]
    require(len(best) == 1, out[-2000:])
    text = best[0].removeprefix("best config: ")
    return [json.loads(ln) for ln in lines], json.loads(
        text[:text.rindex(" (val loss")])


def training_launches(micro, evals, n_attn=34, n_gelu=53):
    """training_counts()'s tuple for ``micro`` bf16 training microbatches
    and ``evals`` forwards."""
    fwd = micro + evals
    return (fwd * n_attn, fwd * 5, fwd * n_gelu, micro * n_attn, micro * 5,
            micro * n_gelu)


def phase_p3(cfg, split):
    """This slice's main path: cli search --vmap-trials at base 416x800
    bf16, batch 2 x 3, P_TRIALS trials x 3 steps; then the vmapped step and
    cli train's one-trial step timed in turns, and one profiled vmapped
    step."""
    t0 = time.perf_counter()
    steps = 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = training_counts()
    t_run = time.perf_counter()
    rc, out = run_cli(search_argv(split, "--vmap-trials", "--num-trials",
                                  str(P_TRIALS), "--trial-steps",
                                  str(steps)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = tuple(a - c for a, c in zip(training_counts(), before))
    require(rc == 0, out[-2000:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    results, best = search_results(out)
    vals = [r["val_loss"] for r in results]
    require(len(results) == P_TRIALS and all(np.isfinite(vals))
            and len(set(vals)) == P_TRIALS, vals)
    require(best == results[int(np.argmin(vals))]["overrides"], best)
    micro = steps * P_ACCUM
    want = training_launches(micro, 1)
    require(launches == want, (launches, want))
    print(f"(p3) cli search --vmap-trials, base 416x800 bf16, batch "
          f"{TRAIN_BATCH} x {P_ACCUM}, {P_TRIALS} trials x {steps} steps on "
          f"the {P_TRAIN}/{P_VAL} split: val losses "
          f"{[round(v, 6) for v in vals]}, best = argmin; launches "
          f"(attention, upsample, gelu, attention bwd, upsample bwd, gelu "
          f"bwd) {launches} = 34 + 34, 5 + 5, 53 + 53 per vmapped microbatch "
          f"for {micro} microbatches, whatever the trial count, and one "
          f"vmapped val forward; {wall:.1f} s, peak memory {peak:.2f} GiB")
    p_step_rates(cfg)
    print(f"(p3) {time.perf_counter() - t0:.1f} s")
    return launches


def p_step_rates(cfg):
    """The vmapped step of P_TRIALS trials and the one-trial train step
    (cli train's) on the same microbatches, timed in turns, then one
    vmapped step under the profiler: ms, per-trial steps/s, device busy,
    idle share, peak memory."""
    from torch.profiler import ProfilerActivity, profile

    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.train.diffgrad import DiffGradNorm
    from camradepth_tpu_torch.train.search import _vmapped_machinery
    from camradepth_tpu_torch.train.step import train_step
    from camradepth_tpu_torch.train.trainer import step_generator

    dev = torch.device("cuda")
    model = create_model(cfg.model, device=dev, seed=0, train=True)
    v_step, _, make_state = _vmapped_machinery(cfg, model, 8, dev)
    micro = [step_inputs(cfg, TRAIN_BATCH, 40 + j, "cuda")
             for j in range(P_ACCUM)]
    for mb in micro:
        mb["features"] = mb["features"].to(torch.bfloat16)
    stacked = {k: torch.stack([mb[k] for mb in micro]) for k in micro[0]}
    params, opt = make_state(P_TRIALS)
    lrs = torch.full((P_TRIALS,), 1e-5, device=dev)
    wds = torch.zeros(P_TRIALS, device=dev)
    single = create_model(cfg.model, device=dev, seed=0, train=True)
    sopt = DiffGradNorm(single.parameters(), lr=1e-5)
    state = {"i": 0}

    def vmapped():
        nonlocal params, opt
        gens = [step_generator(dev, 0, 0, state["i"], j)
                for j in range(P_ACCUM)]
        params, opt, _ = v_step(params, opt, lrs, wds, stacked, gens,
                                state["i"])
        state["i"] += 1

    def one_trial():
        gens = [step_generator(dev, 0, 0, state["i"], j)
                for j in range(P_ACCUM)]
        train_step(cfg, single, sopt, micro, gens, 1e-5)

    vmapped()
    one_trial()  # warm-up of both
    times = {"vmapped": [], "single": []}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        for name, fn in (("vmapped", vmapped), ("single", one_trial)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        vmapped()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t) * 1e3
    kernels = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    v_ms, s_ms = np.mean(times["vmapped"]), np.mean(times["single"])
    print(f"(p3) in turns (vmapped, single) x 2: vmapped step of "
          f"{P_TRIALS} trials {[round(v, 2) for v in times['vmapped']]} ms, "
          f"cli train's one-trial step {[round(v, 2) for v in times['single']]}"
          f" ms: {1e3 * P_TRIALS / v_ms:.3f} trial-steps/s vmapped against "
          f"{1e3 / s_ms:.3f} one trial at a time ({s_ms * P_TRIALS / v_ms:.2f}"
          f"x); peak memory {peak:.2f} GiB (both models); one vmapped step "
          f"under the profiler: {prof_wall:.2f} ms wall, device busy "
          f"{busy:.2f} ms, {sum(e.count for e in kernels)} kernel launches, "
          f"idle share {100 * (1 - busy / prof_wall):.1f} %")
    for e in kernels[:8]:
        ms = e.self_device_time_total / 1e3
        print(f"(p3)   {ms:8.3f} ms {100 * ms / busy:5.1f} % x{e.count:<5d} "
              f"{e.key[:100]}")
    del model, single, sopt, params, opt, micro, stacked
    torch.cuda.empty_cache()


def phase_p4(split):
    """cli search --vmap-trials --halving: rungs of 4 and 2 trials, the
    survivors continuing from their state (3 steps in all, not 1 + 3)."""
    t0 = time.perf_counter()
    before = training_counts()
    rc, out = run_cli(search_argv(split, "--vmap-trials", "--halving",
                                  "--num-trials", "4", "--min-steps", "1",
                                  "--trial-steps", "3"))
    torch.cuda.synchronize()
    launches = tuple(a - c for a, c in zip(training_counts(), before))
    require(rc == 0, out[-2000:])
    results, best = search_results(out)
    rungs = [(r["rung"], r["steps"]) for r in results]
    require(rungs == [(0, 1)] * 4 + [(1, 3)] * 2, rungs)
    r0 = sorted(results[:4], key=lambda r: r["val_loss"])
    require([r["overrides"] for r in r0[:2]]
            == [r["overrides"] for r in results[4:]], "survivors")
    require(best == min(results[4:], key=lambda r: r["val_loss"])[
        "overrides"], best)
    want = training_launches(3 * P_ACCUM, 2)
    require(launches == want, (launches, want))
    print(f"(p4) cli search --vmap-trials --halving (4 trials, min 1, max 3"
          f" steps): rungs of 4 trials at 1 step and 2 at 3, the survivors "
          f"rung 0's best two; {3 * P_ACCUM} vmapped microbatches in all, so "
          f"the survivors continued (launches {launches}); val losses "
          f"{[round(r['val_loss'], 6) for r in results]}; "
          f"{time.perf_counter() - t0:.1f} s")


def phase_p5(split, tmp):
    """The sequential cli search through the Trainer at base 416x800: 2
    trials x 2 steps, and --halving over 3 trials (min 1, max 3), on a 6/2
    split (one optimizer step an epoch)."""
    t0 = time.perf_counter()
    common = ["search", "--split", str(split), "--train-val-split", "6,2",
              "--batch-size", str(TRAIN_BATCH), "--desired-batch-size",
              str(TRAIN_BATCH * P_ACCUM), "--output-dir", str(tmp / "p5")]
    rc, out = run_cli(common + ["--num-trials", "2", "--trial-steps", "2"])
    require(rc == 0, out[-2000:])
    results, best = search_results(out)
    vals = [r["val_loss"] for r in results]
    require(len(results) == 2 and all(np.isfinite(vals)), vals)
    require(best == results[int(np.argmin(vals))]["overrides"], best)
    rc, out = run_cli(common + ["--halving", "--num-trials", "3",
                                "--min-steps", "1", "--trial-steps", "3"])
    require(rc == 0, out[-2000:])
    hres, hbest = search_results(out)
    rungs = [(r["rung"], r["steps"]) for r in hres]
    require(rungs == [(0, 1)] * 3 + [(1, 3)], rungs)
    require(hres[3]["overrides"] == min(hres[:3], key=lambda r: r[
        "val_loss"])["overrides"] == hbest, hres)
    require(all(np.isfinite(r["val_loss"]) for r in hres), hres)
    print(f"(p5) sequential cli search through the Trainer (base 416x800 "
          f"bf16, 6/2 split): 2 trials x 2 steps, val losses "
          f"{[round(v, 6) for v in vals]}; --halving 3 trials at 1 step, "
          f"then the best at 3: {[round(r['val_loss'], 6) for r in hres]}; "
          f"{time.perf_counter() - t0:.1f} s")


def p6_argv(split):
    """(p6)'s cli search: base 416x800 in fp32 (TF32 off), batch 1, 4
    trials x 1 step, one val frame."""
    return ["search", "--split", str(split), "--train-val-split", "2,2",
            "--batch-size", "1", "--desired-batch-size", "1",
            "--compute-dtype", "float32", "--vmap-trials", "--num-trials",
            "4", "--trial-steps", "1"]


def p_rank(argv):
    """One rank of phase (p6) (``chip_smoke.py --rank-p RANK WORLD PORT
    SPLIT``): cli search --vmap-trials --data-parallel WORLD with TF32 off,
    its printed lines echoed with a rank prefix."""
    rank, world, port, split = (int(argv[0]), int(argv[1]), int(argv[2]),
                                argv[3])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rc, out = run_cli(p6_argv(split) + [
        "--data-parallel", str(world), "--coordinator",
        f"127.0.0.1:{port}", "--num-processes", str(world), "--process-id",
        str(rank)])
    for line in out.splitlines():
        print(f"[{rank}] {line}")
    require(rc == 0, (rank, rc))
    print(f"[{rank}] DONE", flush=True)


def start_p6(split, world=2):
    """(p6)'s ranks: cli search --vmap-trials --data-parallel ``world`` on
    ``world`` ranks sharing the card over gloo, started beside (p5)."""
    import os

    import gc

    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    env = dict(os.environ, OMP_NUM_THREADS="1")
    port = str(free_port())
    return time.perf_counter(), [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-p", str(r),
         str(world), port, str(split)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def finish_p6(split, started):
    """(p6): the ranks' val losses against the single-process run of the
    same cli search, which runs once they have ended."""
    t0, procs = started
    world = len(procs)
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        require(p.returncode == 0 and f"[{r}] DONE" in log,
                (r, p.returncode, log[-4000:]))
    t_ranks = time.perf_counter() - t0
    t1 = time.perf_counter()
    rc, out = run_cli(p6_argv(split))
    require(rc == 0, out[-2000:])
    single, _ = search_results(out)
    ranked = [ln.removeprefix("[0] ") for ln in logs[0].splitlines()
              if ln.startswith("[0] ")]
    sharded, _ = search_results("\n".join(ranked))
    require(not any(ln.startswith("[1] {") for ln in logs[1].splitlines()),
            "rank 1 printed results")
    require([r["overrides"] for r in sharded]
            == [r["overrides"] for r in single], "trial order")
    got = np.array([r["val_loss"] for r in sharded])
    want = np.array([r["val_loss"] for r in single])
    rel = np.abs(got - want) / np.abs(want)
    require(bool((rel <= P6_RTOL).all()), (got, want))
    print(f"(p6) cli search --vmap-trials --data-parallel {world} (base "
          f"416x800 fp32, batch 1, 4 trials x 1 step) on {world} ranks "
          f"sharing the card over gloo, 2 trials each: val losses "
          f"{got.tolist()} against one process's {want.tolist()}, largest "
          f"relative difference {rel.max():.3g} (tol {P6_RTOL}); ranks "
          f"{t_ranks:.1f} s (beside (p5)), one process "
          f"{time.perf_counter() - t1:.1f} s")


def phase_p(cfg, split, tmp):
    """This slice's path: hyperparameter search with the trials vmapped
    through the kernels, and the sequential search through the Trainer."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        # (p2)'s CPU reference step, beside (p1) on the card
        cpu_run = pool.submit(p2_step, cfg, "cpu")
        phase_p1(cfg)
        phase_p2(cfg, cpu_run)
    launches = phase_p3(cfg, split)
    phase_p4(split)
    ranks = start_p6(split)
    phase_p5(split, Path(tmp))
    finish_p6(split, ranks)
    print(f"chip_smoke: phase (p) passed in {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------- phase (q)
# the prep estimators at nuScenes' 900x1600
Q_HW = (900, 1600)
Q_RAFT_HW = (904, 1600)  # padded to /8, as dataprep/adapters.py pads
Q_RAFT_ITERS = 20
Q_RADAR_POINTS = 4096


def q_synth_state(model, seed):
    """Seeded random weights for ``model``'s every state_dict tensor (its
    official key set), BatchNorm running statistics included; conv kernels
    ~ N(0, 1.5 / fan_in), the rest ~ N(0, 0.2), variances 0.5 + U(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(1000)
        elif k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif v.ndim == 4:
            fan = max(1, v.shape[1] * v.shape[2] * v.shape[3])
            sd[k] = torch.randn(v.shape, generator=g) * (1.5 / fan) ** 0.5
        else:
            sd[k] = torch.randn(v.shape, generator=g) * 0.2
    return sd


def q_textured(h, w, seed):
    """A smooth random uint8 RGB image (a 5x5 box blur of noise)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 255, (3, h + 4, w + 4)).astype(
        np.float32))
    x = F.avg_pool2d(x[None], 5, stride=1)[0]
    return x.permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def q_time(fn, iters=3):
    """(ms per call over ``iters`` calls after one warm-up, the last
    output)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters, out


def phase_q():
    """The prep estimators and geometry on synthesized official-key weights,
    fp32, TF32 off: each at nuScenes' 900x1600 (finite, two runs equal, ms
    per frame) and at a small size against the port's CPU run."""
    from camradepth_tpu_torch.geometry import raster
    from camradepth_tpu_torch.models import panoptic_deeplab as pdl
    from camradepth_tpu_torch.models import raft
    from camradepth_tpu_torch.ops.optical_flow import lk_flow

    t0 = time.perf_counter()
    h, w = Q_HW
    # RAFT-large: the official key set, 'module.'-prefixed as saved
    state = {f"module.{k}": v for k, v in
             q_synth_state(raft.RAFT(), 40).items()}
    im1 = q_textured(*Q_RAFT_HW, 41)
    im2 = np.roll(im1, (3, -5), axis=(0, 1))
    run = raft.raft_flow_fn(state, iters=Q_RAFT_ITERS, device="cuda")
    ms, flow = q_time(lambda: run(im1[None], im2[None]), iters=2)
    again = run(im1[None], im2[None])
    require(flow.shape == (1, *Q_RAFT_HW, 2)
            and bool(torch.isfinite(flow).all()), flow.shape)
    require(torch.equal(flow, again), "RAFT: two runs differ")
    sm1, sm2 = im1[:128, :256], im2[:128, :256]
    f_card = raft.raft_flow_fn(state, iters=4, device="cuda")(
        sm1[None], sm2[None]).cpu()
    f_cpu = raft.raft_flow_fn(state, iters=4, device="cpu")(sm1[None],
                                                            sm2[None])
    raft_err = (f_card - f_cpu).abs().max().item() / f_cpu.abs().max().item()
    require(raft_err <= 1e-4, ("RAFT card vs CPU", raft_err))
    print(f"(q) RAFT-large ({len(state)} official keys), "
          f"{Q_RAFT_HW[0]}x{Q_RAFT_HW[1]}, {Q_RAFT_ITERS} iterations: finite,"
          f" two runs equal, {ms:.2f} ms per frame pair; 128x256 with 4 "
          f"iterations against the CPU: {raft_err:.3g} of the largest flow "
          f"(tol 1e-4)")
    del run, flow, again
    torch.cuda.empty_cache()
    # Panoptic-DeepLab R101-os32
    model = pdl.PanopticDeepLab()
    model.load_state_dict(q_synth_state(model, 42))
    im = q_textured(h, w, 43)
    est = pdl.classmap_fn(model, device="cuda")
    ms, cls = q_time(lambda: est(im))
    require(cls.shape == Q_HW and cls.min() >= 0
            and cls.max() < pdl.NUM_CLASSES, cls.shape)
    require(np.array_equal(cls, est(im)), "classmap: two runs differ")
    ph, pw = pdl._pad_hw(h, w)
    x = torch.from_numpy(q_textured(161, 321, 44)).float()
    x = ((x - torch.tensor(pdl.MEAN)) / torch.tensor(pdl.STD))[None]
    with torch.no_grad():
        card = {k: v.cpu() for k, v in model.cuda()(x.cuda()).items()}
        ref = model.cpu()(x)
    torch.testing.assert_close(card["semantic"], ref["semantic"], rtol=1e-4,
                               atol=1e-4)
    pdl_err = (card["semantic"] - ref["semantic"]).abs().max().item()
    print(f"(q) Panoptic-DeepLab R101-os32 classmap_fn at {h}x{w} (padded "
          f"to {ph}x{pw}): classes in 0..{pdl.NUM_CLASSES - 1}, two runs "
          f"equal, {ms:.2f} ms per frame; semantic logits at 161x321 against"
          f" the CPU: max abs {pdl_err:.3g} (rtol/atol 1e-4)")
    del model, est
    torch.cuda.empty_cache()
    # Lucas-Kanade
    a = q_textured(h, w, 45)
    b = np.roll(a, (2, -3), axis=(0, 1))
    ms, flow = q_time(lambda: lk_flow(a, b, device="cuda"))
    require(flow.shape == (h, w, 2) and np.isfinite(flow).all(), flow.shape)
    require(np.array_equal(flow, lk_flow(a, b, device="cuda")),
            "LK: two runs differ")
    med = np.median(flow[50:-50, 50:-50], axis=(0, 1))
    sa, sb = a[:96, :128], b[:96, :128]
    lk_err = float(np.abs(lk_flow(sa, sb, device="cuda")
                          - lk_flow(sa, sb, device="cpu")).max())
    require(lk_err <= 1e-4, ("LK card vs CPU", lk_err))
    print(f"(q) lk_flow at {h}x{w}: finite, two runs equal, {ms:.2f} ms per "
          f"frame pair, interior median ({med[0]:.3f}, {med[1]:.3f}) px for "
          f"content moved by (-3, 2); 96x128 against the CPU: {lk_err:.3g} "
          f"px (atol 1e-4)")
    # radar raster
    rng = np.random.default_rng(46)
    n = Q_RADAR_POINTS
    f32 = lambda v: torch.from_numpy(np.asarray(v, np.float32))
    x1, y1 = f32(rng.uniform(0, w - 1, n)), f32(rng.uniform(0, h - 1, n))
    args = dict(depth1=f32(rng.uniform(2, 100, n)),
                times1=f32(rng.uniform(0, 0.5, n)),
                x2=x1 + f32(rng.uniform(-3, 3, n)),
                y2=y1 + f32(rng.uniform(-3, 3, n)),
                rcs=f32(rng.uniform(-5, 10, n)),
                v_comp=f32(rng.uniform(0, 2, n)),
                valid=torch.from_numpy(rng.random(n) < 0.95))
    on = {k: v.cuda() for k, v in args.items()}
    ms, maps = q_time(lambda: raster.rasterize_radar(x1.cuda(), y1.cuda(),
                                                     **on))
    again = raster.rasterize_radar(x1.cuda(), y1.cuda(), **on)
    cpu = raster.rasterize_radar(x1, y1, **args)
    for k, v in maps.items():
        require(bool(torch.isfinite(v).all()), k)
        require(torch.equal(v, again[k]), ("raster: two runs differ", k))
        require(torch.equal(v.cpu(), cpu[k]), ("raster card vs CPU", k))
    print(f"(q) rasterize_radar of {n} points at {h}x{w} (maps "
          f"{tuple(maps['depth'].shape)}, {int((maps['depth'] > 0).sum())} "
          f"hit): finite, two runs equal, bit for bit with the CPU; "
          f"{ms:.3f} ms per frame")
    print(f"chip_smoke: phase (q) passed in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------- phase (r)
# the offline prep (dataprep/, cli prep) on the synthetic nuScenes world of
# tests/torch_fake_nuscenes.py with real 900x1600 camera jpgs: its smallest
# world whose (mini) split keeps 4 frames is one scene of 8 samples (the
# split drops two samples at each scene edge)
R_WORLD = dict(n_scenes=1, samples_per_scene=8)
R_FRAMES = 4
R_HOST_STAGES = ("matrices", "uv", "gt", "radar", "filter", "split_file")
R_TEST_BATCH = 2  # two batches, so that the report has its steady rates
# RAFT-large on (q)'s synthesized official keys gives ~60 px of flow on the
# world's frames (whose content moves by under a pixel): the occlusion
# filter (lidar against image flow, 3 px) would drop every lidar point and
# (r3) would score no pixel. Its flow head's last conv scaled by this gives
# ~0.8 px (measured at 128x256 on the CPU)
R_FLOW_HEAD_SCALE = 1e-2


def same_prepared(got_dir, want_dir, names=None):
    """The artifact files of two prepared directories (all of want_dir's,
    or ``names``) equal bit for bit, the split tables' paths rebased;
    returns the names compared."""
    names = names or sorted(p.name for p in want_dir.iterdir())
    for name in names:
        got, want = got_dir / name, want_dir / name
        if name == "split.npy":
            same = np.array_equal(
                np.char.replace(np.load(got), str(got_dir), ""),
                np.char.replace(np.load(want), str(want_dir), ""))
        else:
            same = got.read_bytes() == want.read_bytes()
        require(same, ("prepared files differ", name))
    return names


def phase_r(weights, counters, reset_counters):
    """The offline prep on the card. (r1) run_pipeline's ten stages with
    RAFT-large (``--flow jax-raft``, 20 iterations) and Panoptic-DeepLab
    (``--seg jax-panoptic``, remap cityscapes) on synthesized official-key
    weights, twice (one call, then a call per stage, timed): the same
    files; (r2) the six host stages again from (r1)'s jpgs, flow and mseg
    on the CPU: the same files; (r3) cli validate-data and cli test --preset
    base (bf16, the golden's weights) on the prepared directory, 34 / 5 /
    53 launches per forward; (r4) cli prep's two refusals."""
    from camradepth_tpu_torch.dataprep import adapters
    from camradepth_tpu_torch.dataprep.pipeline import (
        ALL_STAGES,
        run_pipeline,
    )
    from camradepth_tpu_torch.models import panoptic_deeplab as pdl
    from camradepth_tpu_torch.models import raft
    from tests.torch_fake_nuscenes import FakeNuscenes

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        world = FakeNuscenes(**R_WORLD, image_root=tmp / "nusc")
        state = q_synth_state(raft.RAFT(), 40)
        for k in ("weight", "bias"):
            state[f"update_block.flow_head.conv2.{k}"] *= R_FLOW_HEAD_SCALE
        torch.save({f"module.{k}": v for k, v in state.items()},
                   tmp / "raft-things.pth")
        torch.save(q_synth_state(pdl.PanopticDeepLab(), 42), tmp / "pdl.pth")
        kw = dict(
            flow_estimator=adapters.make_flow_estimator(
                "jax-raft", ckpt=str(tmp / "raft-things.pth"),
                device="cuda", iters=Q_RAFT_ITERS),
            seg_estimator=adapters.make_seg_estimator(
                "jax-panoptic", ckpt=str(tmp / "pdl.pth"), device="cuda"),
            seg_remap="cityscapes", mini=True, progress=False,
            device="cuda")
        t1 = time.perf_counter()
        # (r1) all ten stages in one call, then again one call a stage
        run_pipeline(world, tmp / "r1", **kw)
        ms = {}
        for stage in ALL_STAGES:
            t = time.perf_counter()
            run_pipeline(world, tmp / "r1_again", stage_names=(stage,), **kw)
            ms[stage] = (time.perf_counter() - t) * 1e3 / R_FRAMES
        t2 = time.perf_counter()
        names = same_prepared(tmp / "r1_again", tmp / "r1")
        n_frames = len(json.loads((tmp / "r1" / "data_split.json")
                                  .read_text())["all"])
        require(n_frames == R_FRAMES, n_frames)
        for suffix in ("_im.jpg", "_im_next.jpg", "_flow.npy", "_mseg.npy",
                       "_matrix.npz", "_im_uv.npy", "_gt.npy", "_msk_lh.npy",
                       "_radar.npy", "_rad_vel.npy", "_radar_filtered.npy"):
            require(sum(n.endswith(suffix) for n in names) == R_FRAMES,
                    suffix)
        for name in names:
            if name.endswith(".npy") and name != "split.npy":
                a = np.load(tmp / "r1" / name)
                require(a.dtype == bool or np.isfinite(a).all(), name)
        print(f"(r1) run_pipeline, all ten stages on the card, {R_FRAMES} "
              f"frames of a {R_WORLD['n_scenes']}x"
              f"{R_WORLD['samples_per_scene']}-sample world with 900x1600 "
              f"camera jpgs (jax-raft {Q_RAFT_ITERS} iterations, "
              f"jax-panoptic): {len(names)} files, two runs bit for bit; "
              f"ms per frame (second run; {smi}): "
              + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
              + f"; total {sum(ms.values()):.1f}")
        # (r2) the host stages again on the CPU from (r1)'s jpgs, flow, mseg
        r2 = tmp / "r2"
        r2.mkdir()
        for name in names:
            if name == "data_split.json" or name.endswith(
                    ("_im.jpg", "_im_next.jpg", "_flow.npy", "_mseg.npy")):
                (r2 / name).write_bytes((tmp / "r1" / name).read_bytes())
        t = time.perf_counter()
        run_pipeline(world, r2, stage_names=R_HOST_STAGES, progress=False,
                     device="cpu")
        cpu_ms = (time.perf_counter() - t) * 1e3 / R_FRAMES
        same_prepared(r2, tmp / "r1")
        print(f"(r2) the stages {', '.join(R_HOST_STAGES)} on the CPU from "
              f"(r1)'s jpgs, flow and mseg: every file = (r1)'s bit for bit "
              f"({cpu_ms:.1f} ms per frame)")
        t3 = time.perf_counter()
        # (r3) the prepared directory on the main path
        from camradepth_tpu_torch.config import preset

        rc, out = run_cli(["validate-data", "--data-dir", str(tmp / "r1")])
        require(rc == 0 and f"checked {R_FRAMES} rows: OK" in out, out)
        pth = tmp / "base_golden.pth"
        torch.save({"state_dict": {k: torch.from_numpy(v)
                                   for k, v in weights.items()}}, pth)
        report_path = tmp / "r3.json"
        reset_counters()
        rc, out = run_cli(["test", "--preset", "base", "--split",
                           str(tmp / "r1" / "split.npy"), "--mini-dataset",
                           "--checkpoint", str(pth), "--test-batch",
                           str(R_TEST_BATCH), "--report-json",
                           str(report_path)])
        torch.cuda.synchronize()
        launches = counters()
        require(rc == 0, (rc, out))
        report = json.loads(report_path.read_text())
        require(tuple(sorted(report)) == tuple(sorted(REPORT_KEYS)),
                sorted(set(report) ^ set(REPORT_KEYS)))
        # the prep's split holds clear-day scenes only (build_scene_split
        # sets rain and night aside), so the rain RMSE has no frame
        require(report["frames"] == R_FRAMES
                and np.isnan(report["rmse_edge"])
                and all(np.isfinite(v) for k, v in report.items()
                        if k != "rmse_edge"), report)
        cfg = preset("base")
        n_attn, n_up, n_gelu = variant_counts(cfg.model)
        n_fwd = -(-R_FRAMES // R_TEST_BATCH)
        want = (n_fwd * n_attn, n_fwd * n_up, 0, n_fwd * n_gelu)
        require(launches == want, (launches, want))
        print(f"(r3) cli validate-data: OK; cli test --preset base (bf16, "
              f"the golden's weights) on the prepared {R_FRAMES} frames: "
              f"rmse_100={report['rmse_100']:.4f} mae_100="
              f"{report['mae_100']:.4f} rmse_50={report['rmse_50']:.4f}, "
              f"every key finite but rmse_edge (no rain frame); launches "
              f"{launches} = {n_fwd} forwards x ({n_attn}, {n_up}, 0, "
              f"{n_gelu})")
        # (r4) cli prep's answers without the nuscenes-devkit
        for extra, text in (([], "needs the nuscenes-devkit"),
                            (["--seg", "jax-panoptic", "--seg-remap",
                              "merged"], "--seg-remap must be one of")):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc, _ = run_cli(["prep", "--data-root", str(tmp / "nusc"),
                                 "--out", str(tmp / "r4")] + extra)
            require(rc == 2 and text in err.getvalue(),
                    (extra, rc, err.getvalue()))
            print(f"(r4) cli prep {' '.join(extra) or '(no devkit)'}: rc 2, "
                  f"{err.getvalue().strip().splitlines()[0][:90]}")
        require(not (tmp / "r4").exists(), "cli prep wrote output")
    print(f"chip_smoke: phase (r) passed in {time.perf_counter() - t0:.1f} s"
          f" (set-up {t1 - t0:.1f}, (r1) {t2 - t1:.1f}, (r2) {t3 - t2:.1f},"
          f" (r3)+(r4) {time.perf_counter() - t3:.1f})")


# ---------------------------------------------------------------- phase (s)

# the keys of the JAX package's bench line (bench.py:355-372, :282-288)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "batch1_latency_ms",
              "batch", "device", "gflops_per_frame", "achieved_tflops",
              "attainable_ms_per_frame", "roofline_pct", "tpu_variant_fps",
              "tpu_variant_vs_baseline", "tpu_variant_batch1_latency_ms",
              "tpu_variant_roofline_pct", "tpu_variant_gflops_per_frame")
# PERF.md section 6's bound column, per bf16 batch-8 forward of base at
# 416x800: what utils/roofline.py's kernel floors must reproduce
TABLE_BOUND_MS = {"maxpool_attention_scores": 0.080,
                  "upsample_bicubic_x2": 0.342, "gelu_bf16": 2.198}
# frames of (g)'s corpus that cli viz draws, and the share of collage
# pixels in which the artifact's may differ from the .pth's (the same
# bf16 program, bit for bit in (k1))
VIZ_FRAMES = 4
VIZ_PIXEL_SHARE = 1e-3
# cli summary --preset base in a process of its own, which must leave
# CUDA untouched
SUMMARY_CODE = (
    "import sys, torch\n"
    "from camradepth_tpu_torch import cli\n"
    "rc = cli.main(['summary', '--preset', 'base', '--project-scaling', "
    "'weak'])\n"
    "print('cuda initialized:', torch.cuda.is_initialized())\n"
    "sys.exit(rc)\n"
)


def s_bench(argv, counters, reset_counters):
    """``cli bench`` (and ``--train``): its one JSON line, held to the JAX
    bench's keys, the card, the launches per timed forward and the
    roofline."""
    reset_counters()
    t = time.perf_counter()
    rc, out = run_cli(["bench", *argv])
    torch.cuda.synchronize()
    launches = counters()
    seconds = time.perf_counter() - t
    lines = out.strip().splitlines()
    require(rc == 0 and len(lines) == 1, (rc, out[-2000:]))
    line = json.loads(lines[0])
    require(all(k in line for k in BENCH_KEYS),
            sorted(set(BENCH_KEYS) - set(line)))
    require(line["batch"] == BATCH and line["value"] > 0
            and torch.cuda.get_device_name(0) in line["device"]
            and "W" in line["device"], line)
    for key, variant in (("launches_per_forward", False),
                         ("tpu_variant_launches_per_forward", True)):
        want = FORWARD_LAUNCHES[False, variant]
        got = tuple(line[key][k] for k in ("maxpool_attention_scores",
                                           "upsample_bicubic_x2",
                                           "gelu_bf16"))
        require(got == want, (key, got, want))
    ms_per_frame = 1e3 / line["value"]
    require(line["attainable_ms_per_frame"] <= ms_per_frame,
            (line["attainable_ms_per_frame"], ms_per_frame))
    require(launches[0] > 0 and launches[1] > 0 and launches[3] > 0,
            launches)
    if "--train" in argv:
        require(line["train_step_ms_batch6"] > 0
                and line["train_frames_per_sec"] > 0, line)
    print(f"(s1) cli bench {' '.join(argv)} ({seconds:.1f} s): "
          f"{json.dumps(line)}")
    print(f"(s1) launches in that run: attention, bicubic, conv, GELU = "
          f"{launches}; per timed forward {line['launches_per_forward']} "
          f"(tpu_decoder {line['tpu_variant_launches_per_forward']}); "
          f"attainable {line['attainable_ms_per_frame']} ms/frame <= "
          f"measured {ms_per_frame:.2f} ms/frame")
    return line


# cli viz on an artifact in a process of its own: the program's load is
# Python-bound (10-28 s at base's depth), so it runs beside the rest of
# (s); the process prints its forward kernels' launch counts last
VIZ_ARTIFACT_CODE = (
    "import json, sys, torch\n"
    "from camradepth_tpu_torch import cli\n"
    "from camradepth_tpu_torch.ops.attention import "
    "maxpool_attention_scores as a\n"
    "from camradepth_tpu_torch.ops.gelu import gelu_bf16 as g\n"
    "from camradepth_tpu_torch.ops.resize import upsample_bicubic_x2 as u\n"
    "rc = cli.main(sys.argv[1:])\n"
    "torch.cuda.synchronize()\n"
    "print(json.dumps([a.launches, u.launches, g.launches]))\n"
    "sys.exit(rc)\n"
)


def viz_argv(head, ckpt, out):
    return ["viz", "--split", str(head), "--mini-dataset", "--checkpoint",
            str(ckpt), "--out", str(out), "--num-vis", str(VIZ_FRAMES)]


def s_viz(head, pth, art_proc, tmp, counters, reset_counters):
    """``cli viz`` on the golden's weights here and on the bf16 artifact in
    ``art_proc`` over VIZ_FRAMES frames: one forward each at 34 / 5 / 53
    launches, the same collages."""
    import cv2

    want = FORWARD_LAUNCHES[False, False]
    reset_counters()
    rc, text = run_cli(viz_argv(head, pth, tmp / "viz_pth"))
    torch.cuda.synchronize()
    launches = counters()
    require(rc == 0 and f"wrote {VIZ_FRAMES} collages" in text, (rc, text))
    require((launches[0], launches[1], launches[3]) == want,
            ("pth", launches, want))
    out, err = art_proc.communicate(timeout=600)
    lines = out.strip().splitlines()
    require(art_proc.returncode == 0 and lines
            and f"wrote {VIZ_FRAMES} collages" in out, (out, err[-2000:]))
    require(tuple(json.loads(lines[-1])) == want, ("artifact", lines[-1]))
    pngs = {name: {p.name: cv2.imread(str(p)) for p in
                   sorted((tmp / f"viz_{name}").glob("*.png"))}
            for name in ("pth", "artifact")}
    got, want_png = pngs["artifact"], pngs["pth"]
    require(len(want_png) == VIZ_FRAMES and sorted(got) == sorted(want_png),
            (sorted(got), sorted(want_png)))
    diff = sum(int((got[k] != want_png[k]).any(-1).sum()) for k in got)
    total = sum(v.shape[0] * v.shape[1] for v in got.values())
    require(diff <= VIZ_PIXEL_SHARE * total, (diff, total))
    print(f"(s4) cli viz on the .pth and on the bf16 artifact: "
          f"{VIZ_FRAMES} collages each ({sorted(got)}), one forward each "
          f"at {want} launches; {diff} of {total} pixels differ")


def s_inspect(pth, art, split):
    """``cli inspect`` on the .pth, the artifact and the split."""
    for path, kind in ((pth, "reference-pth"),
                       (art, "torch-export-artifact"),
                       (split, "split-table")):
        rc, out = run_cli(["inspect", str(path)])
        info = json.loads(out) if rc == 0 else {}
        require(rc == 0 and info.get("type") == kind, (path, rc, out[:500]))
        what = {"reference-pth": lambda: f"{info['params']:,} params",
                "torch-export-artifact": lambda: (
                    f"{info['header']['artifact_dtype']} batch "
                    f"{info['header']['batch_size']}, "
                    f"{info['blob_bytes']:,} program bytes"),
                "split-table": lambda: f"shape {info['shape']}"}[kind]()
        print(f"(s5) cli inspect {Path(path).name}: {kind}, {what}")


def s_start(split, art):
    """(s3), (s6) and the artifact's viz in processes of their own, started
    ahead of (s) (beside (q) and (r) in a whole run): the artifact's load
    is Python-bound, 10-28 s at base's depth. Returns (temporary dir, the
    viz split, the processes)."""
    from camradepth_tpu_torch.data.split import save_split

    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    head = save_split(np.load(split)[:VIZ_FRAMES], tmp / "viz_split.npy")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(argv, cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv in (
                 [sys.executable, "-c", VIZ_ARTIFACT_CODE,
                  *viz_argv(head, art, tmp / "viz_artifact")],
                 [sys.executable, "-c", SUMMARY_CODE],
                 [sys.executable, "-m", "camradepth_tpu_torch.cli",
                  "doctor", "--timeout", "120"])]
    return tmp_dir, head, procs


def phase_s(pth, art, started, counters, reset_counters):
    """The tools: (s1) cli bench and cli bench --train, each one JSON line
    with the JAX bench's keys, 34 / 5 / 53 (tpu_decoder 34 / 3 / 53)
    launches per timed forward and an attainable floor at or under the
    measured ms per frame; (s2) the roofline's per-kernel floors at base
    batch 8 against PERF.md section 6's bound column; (s3) cli summary
    --preset base in a process that leaves CUDA untouched; (s4) cli viz
    on the golden's weights and on (k1)'s bf16 artifact over 4 of (g)'s
    frames; (s5) cli inspect on the .pth, the artifact and the split; (s6)
    cli doctor, rc 0, naming the card. ``started`` is :func:`s_start`'s."""
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.utils import roofline as rl

    tmp_dir, head, procs = started
    tmp = Path(tmp_dir.name)
    art_viz, summary, doctor = procs
    t0 = time.perf_counter()
    try:
        s_bench([], counters, reset_counters)
        s_bench(["--train"], counters, reset_counters)
        t1 = time.perf_counter()
        # (s2) the kernels' floors, summed over a forward's launches
        r = rl.forward_roofline(preset("base").model, BATCH)
        floors = {k: round(v * 1e3, 3) for k, v in r.kernel_floors().items()}
        require(floors == TABLE_BOUND_MS, (floors, TABLE_BOUND_MS))
        print(f"(s2) roofline kernel floors per bf16 batch-{BATCH} forward "
              f"(ms): {floors} = PERF.md's bound column; attainable "
              f"{r.attainable_s / BATCH * 1e3:.3f} ms/frame (matmul "
              f"{r.t_matmul_floor * 1e3:.3f}, kernels "
              f"{r.t_kernel_floor * 1e3:.3f}, unfused eager bytes "
              f"{r.t_other_floor * 1e3:.3f} ms a batch)")
        s_viz(head, pth, art_viz, tmp, counters, reset_counters)
        s_inspect(pth, art, head)
        t2 = time.perf_counter()
        out, err = summary.communicate(timeout=300)
        require(summary.returncode == 0
                and "TOTAL" in out and "21,966,595" in out
                and "cuda initialized: False" in out, (out, err[-2000:]))
        gf = next(line for line in out.splitlines()
                  if line.startswith("matmul GFLOPs"))
        print(f"(s3) cli summary --preset base (no CUDA context): TOTAL "
              f"21,966,595; {gf}")
        out, err = doctor.communicate(timeout=300)
        require(doctor.returncode == 0
                and torch.cuda.get_device_name(0) in out, (out, err[-2000:]))
        print("(s6) cli doctor: rc 0; " + "; ".join(
            line for line in out.splitlines()
            if line.startswith(("device 0", "nvidia-smi", "nvcc"))))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        tmp_dir.cleanup()
    print(f"chip_smoke: phase (s) passed in {time.perf_counter() - t0:.1f} s"
          f" (the benches {t1 - t0:.1f}, (s2), (s4), (s5) {t2 - t1:.1f}, then "
          f"waiting on summary and doctor {time.perf_counter() - t2:.1f})")


def phase_s_alone():
    """(s) alone after (a) (``python3 chip_smoke.py --phase s``): a corpus
    of VIZ_FRAMES frames, the golden's weights as a .pth and a bf16
    artifact of them made first."""
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.data import synthetic

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_a()
    cfg = preset("base")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        split = synthetic.generate(tmp / "data", num_frames=VIZ_FRAMES,
                                   hw=cfg.model.img_size, seed=0,
                                   rain_every=4)
        pth = tmp / "base_golden.pth"
        torch.save({"state_dict": {k: torch.from_numpy(v)
                                   for k, v in golden_weights()[1].items()}},
                   pth)
        art = tmp / "base_bf16.pt2"
        rc, out = run_cli(["export", "--checkpoint", str(pth), "--out",
                           str(art), "--format", "artifact",
                           "--artifact-dtype", "bfloat16", "--serve-batch",
                           str(BATCH)])
        require(rc == 0, (rc, out))
        phase_s(pth, art, s_start(split, art), forward_counts,
                reset_forward_counts)


def phase_p_alone():
    """(p) with what it needs from the earlier phases (``python3
    chip_smoke.py --phase p``): the kernels' build and (g)'s 32-frame
    corpus made again."""
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.data import synthetic

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_a()
    cfg = preset("base")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        h, w = cfg.model.img_size
        split = synthetic.generate(tmp / "data", num_frames=P_TRAIN + P_VAL,
                                   hw=(h, w), seed=0, rain_every=4)
        phase_p(cfg, split, tmp)


def phase_q_alone():
    """(q) alone after (a) (``python3 chip_smoke.py --phase q``)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_a()
    phase_q()


def reset_forward_counts():
    from camradepth_tpu_torch.ops.attention import maxpool_attention_scores
    from camradepth_tpu_torch.ops.conv_fused import conv3x3_fused
    from camradepth_tpu_torch.ops.gelu import gelu_bf16
    from camradepth_tpu_torch.ops.resize import upsample_bicubic_x2

    for fn in (maxpool_attention_scores, upsample_bicubic_x2, conv3x3_fused,
               gelu_bf16):
        fn.launches = 0


def phase_r_alone():
    """(r) alone after (a) (``python3 chip_smoke.py --phase r``)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_a()
    phase_r(golden_weights()[1], forward_counts, reset_forward_counts)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this runs on the card")
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == ["--rank-n"]:  # a rank of phase (n)
        n_rank(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--rank-o"]:  # a rank of phase (o)
        o_rank(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--rank-p"]:  # a rank of phase (p6)
        p_rank(sys.argv[2:])
        return
    if sys.argv[1:] == ["--phase", "p"]:
        phase_p_alone()
        return
    if sys.argv[1:] == ["--phase", "q"]:
        phase_q_alone()
        return
    if sys.argv[1:] == ["--phase", "r"]:
        phase_r_alone()
        return
    if sys.argv[1:] == ["--phase", "s"]:
        phase_s_alone()
        return
    if sys.argv[1:] == ["--phase", "n"]:
        phase_n_alone()
        return
    if sys.argv[1:] == ["--phase", "o"]:
        phase_o_alone()
        return
    if sys.argv[1:]:
        sys.exit(f"chip_smoke: unknown arguments {sys.argv[1:]}")
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.ops.attention import (
        maxpool_attention_scores,
        maxpool_attention_scores_backward,
    )
    from camradepth_tpu_torch.ops.conv_fused import conv3x3_fused
    from camradepth_tpu_torch.ops.gelu import gelu_bf16, gelu_bf16_backward
    from camradepth_tpu_torch.ops.resize import (
        upsample_bicubic_x2,
        upsample_bicubic_x2_backward,
    )

    wrappers = (maxpool_attention_scores, upsample_bicubic_x2, conv3x3_fused,
                gelu_bf16, maxpool_attention_scores_backward,
                upsample_bicubic_x2_backward, gelu_bf16_backward)

    counters = forward_counts  # the forward kernels' four counts

    def all_counters():
        return tuple(fn.launches for fn in wrappers)

    def reset_counters():
        for fn in wrappers:
            fn.launches = 0  # the backward kernels' counts too

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    phase_a()
    cfg = preset("base")
    rec = phase_b(cfg)
    t1 = time.perf_counter()
    golden, weights = golden_weights()
    ref_model = phase_c(cfg, golden, weights, counters)
    t2 = time.perf_counter()
    launches, engine, frames, stream_stats = phase_d(
        cfg, weights, ref_model, counters, reset_counters)
    t3 = time.perf_counter()
    phase_e(engine, frames, stream_stats, counters, reset_counters)
    t4 = time.perf_counter()
    rec["conv3x3_fused"] = phase_f(cfg, counters, reset_counters)
    t5 = time.perf_counter()
    corpus = tempfile.TemporaryDirectory()  # (g)'s, read again in (l)
    split, pth = phase_g(cfg, weights, counters, reset_counters,
                         Path(corpus.name))
    t6 = time.perf_counter()
    rec.update(phase_h_kernels(cfg))
    phase_h_step_parity(cfg)
    train_launches = phase_h_train(cfg, all_counters, reset_counters)
    t7 = time.perf_counter()
    phase_i(counters, all_counters, reset_counters)
    t8 = time.perf_counter()
    phase_j(weights, all_counters, counters, reset_counters)
    t9 = time.perf_counter()
    art = phase_k(weights, reset_counters, counters, Path(corpus.name))
    t10 = time.perf_counter()
    phase_l(cfg, split, pth, Path(corpus.name), counters, reset_counters)
    t11 = time.perf_counter()
    phase_m(cfg, split, all_counters, reset_counters)
    t12 = time.perf_counter()
    # (n)'s ranks start after (m3)'s processes have ended
    phase_n(cfg, ref_model, engine, golden, split, pth, Path(corpus.name))
    t13 = time.perf_counter()
    print(f"chip_smoke: {t13 - t0:.1f} s before (o) (limit 1200 s)")
    del engine, ref_model
    torch.cuda.empty_cache()
    phase_o(cfg, split, pth, Path(corpus.name))
    t14 = time.perf_counter()
    search_launches = phase_p(cfg, split, Path(corpus.name))
    t15 = time.perf_counter()
    started = s_start(split, art)  # (s)'s worker processes, beside (q), (r)
    phase_q()
    t16 = time.perf_counter()
    phase_r(weights, counters, reset_counters)
    t17 = time.perf_counter()
    phase_s(pth, art, started, counters, reset_counters)
    corpus.cleanup()
    t18 = time.perf_counter()
    print(f"phase seconds: (a)+(b) {t1 - t0:.1f}, (c) {t2 - t1:.1f}, "
          f"(d) {t3 - t2:.1f}, (e) {t4 - t3:.1f}, (f) {t5 - t4:.1f}, "
          f"(g) {t6 - t5:.1f}, (h) {t7 - t6:.1f}, (i) {t8 - t7:.1f}, "
          f"(j) {t9 - t8:.1f}, (k) {t10 - t9:.1f}, (l) {t11 - t10:.1f}, "
          f"(m) {t12 - t11:.1f}, (n) {t13 - t12:.1f}, (o) {t14 - t13:.1f}, "
          f"(p) {t15 - t14:.1f}, (q) {t16 - t15:.1f}, (r) {t17 - t16:.1f}, "
          f"(s) {t18 - t17:.1f}; total {t18 - t0:.1f} s (limit 1200 s)")
    # the vmapped search's main path launched every training kernel
    require(all(n > 0 for n in search_launches), search_launches)
    # launches: kernels 1 and 2 and GELU from the serving run of (d), the
    # fused conv from its own main path in (f), the backward kernels from
    # the training run of (h)
    n_launch = {"maxpool_attention_scores": launches[0],
                "upsample_bicubic_x2": launches[1],
                "conv3x3_fused": rec["conv3x3_fused"].pop("launches"),
                "gelu_bf16": launches[3],
                "maxpool_attention_scores_backward": train_launches[4],
                "upsample_bicubic_x2_backward": train_launches[5],
                "gelu_bf16_backward": train_launches[6]}
    kernels = []
    for name, r in rec.items():
        n = n_launch[name]
        kernels.append({"name": name, "route": r["route"],
                        "source": r["source"], "replaces": r["replaces"],
                        "launches": n, "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
