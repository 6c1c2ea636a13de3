"""Headline benchmark: nuScenes-resolution inference throughput per card.

Counterpart of the JAX package's ``bench.py`` (``cli bench``). Prints ONE
JSON line with its keys: ``metric``, ``value`` (frames/s), ``unit``,
``vs_baseline``, ``batch1_latency_ms``, ``batch``, ``device`` (the card's
name and power limit, as ``nvidia-smi --query-gpu=name,power.limit``
gives them), the roofline fields ``gflops_per_frame``,
``achieved_tflops``, ``attainable_ms_per_frame`` and ``roofline_pct``
(``utils/roofline.py``), the ``tpu_variant_*`` fields (``base`` with
``tpu_decoder``) and, with ``--train``, ``train_step_ms_batch6`` and
``train_frames_per_sec``. It adds ``launches_per_forward`` (and
``tpu_variant_launches_per_forward``): each Hopper kernel's launches per
timed forward, read from the wrappers' counts.

What it measures: steady-state frames/s of the ``base`` model (416x800, 7
channels, bf16, random weights from a seed) on the card: K forwards of a
batch after warm-up, timed by CUDA events around them and a synchronise,
divided into K x batch frames; at batch 1 the same gives the latency.
The train step is the JAX bench's: one microbatch of 6 padded to 8, both
remats on, diffGradNorm, timed over 4 steps after 3.

vs_baseline: the baseline comes from ``baseline_measured.json`` at the
root of the checkout, as the JAX bench reads it (the paper's desktop-GPU
setting, ~25 frames/s; 25.0 when the file is missing).

A failure still prints one JSON line, with ``"value": null`` and an
``"error"``, and exits non-zero. There is no CPU fallback: ``main`` runs
on ``cuda``; :func:`run_bench` takes ``device="cpu"`` for the tests, at a
tiny size.

    python -m camradepth_tpu_torch.cli bench [--train]
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict

import torch

METRIC = "nuScenes 416x800 camera+radar inference throughput"
UNIT = "frames/sec/chip"
BATCH = 8
ITERS = 16
WARMUP = 3
TRAIN_STEPS = 4
TRAIN_WARMUP = 3
TRAIN_BATCH = 6  # one microbatch of 6 padded to 8, as the JAX bench


def baseline_fps() -> float:
    path = Path(__file__).resolve().parents[1] / "baseline_measured.json"
    try:
        return float(json.loads(path.read_text())["baseline_fps"])
    except (OSError, KeyError, ValueError):
        return 25.0


def device_label(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them (the
    name alone where it does not answer); ``cpu`` on the CPU."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else 0
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return torch.cuda.get_device_name(device)


def _kernel_counters():
    from camradepth_tpu_torch.ops.attention import maxpool_attention_scores
    from camradepth_tpu_torch.ops.gelu import gelu_bf16
    from camradepth_tpu_torch.ops.resize import upsample_bicubic_x2

    return {"maxpool_attention_scores": maxpool_attention_scores,
            "upsample_bicubic_x2": upsample_bicubic_x2,
            "gelu_bf16": gelu_bf16}


def _elapsed_ms(fn, iters: int, device: torch.device) -> float:
    """Mean ms of ``fn()`` over ``iters`` calls after the queue drained:
    CUDA events around them and a synchronise on the card, the host clock
    on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def timed_forward(model, x: torch.Tensor, iters: int) -> Dict:
    """(ms per forward, launches per timed forward by kernel) of ``model``
    on ``x``, timed over ``iters`` forwards after WARMUP."""
    counters = _kernel_counters()

    def fwd():
        model(x)

    with torch.inference_mode():
        for _ in range(WARMUP):
            fwd()
        before = {k: f.launches for k, f in counters.items()}
        ms = _elapsed_ms(fwd, iters, x.device)
    launches = {k: (f.launches - before[k]) / iters
                for k, f in counters.items()}
    return {"ms": ms, "launches": launches}


def roofline_fields(model_cfg, batch: int, fps: float) -> Dict:
    """The attainable-floor fields of the batch-``batch`` forward beside a
    measured ``fps`` (``utils/roofline.py``)."""
    from camradepth_tpu_torch.utils import roofline as rl

    r = rl.forward_roofline(model_cfg, batch)
    attainable_ms = r.attainable_s / batch * 1e3
    flops = sum(op.flops for op in r.matmuls) / batch
    return {
        "gflops_per_frame": round(flops / 1e9, 1),
        "achieved_tflops": round(flops * fps / 1e12, 1),
        "attainable_ms_per_frame": round(attainable_ms, 2),
        "roofline_pct": round(100.0 * attainable_ms * fps / 1e3, 1),
    }


def run_bench(cfg, device="cuda", batch: int = BATCH, iters: int = ITERS
              ) -> Dict:
    """frames/s of ``cfg``'s model (weights from seed 0, the input from
    seed 1) at ``batch`` and its batch-1 latency on ``device``, launches
    per timed forward and the roofline fields at ``batch``."""
    from camradepth_tpu_torch import resolve_device
    from camradepth_tpu_torch.models.camradepth import create_model

    dev = resolve_device(device)
    model = create_model(cfg.model, device=dev, seed=0)
    h, w = cfg.model.img_size
    g = torch.Generator().manual_seed(1)
    x = torch.randn((batch, h, w, cfg.model.input_channels),
                    generator=g).to(dev)
    full = timed_forward(model, x, iters)
    one = timed_forward(model, x[:1], iters)
    fps = batch * 1e3 / full["ms"]
    return {"fps": fps, "batch1_latency_ms": one["ms"],
            "launches_per_forward": full["launches"],
            **roofline_fields(cfg.model, batch, fps)}


def train_fields(device="cuda", steps: int = TRAIN_STEPS) -> Dict:
    """ms of the JAX bench's train step (``base``, one microbatch of 6
    padded to 8, both remats) on ``device``."""
    from camradepth_tpu_torch import resolve_device
    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.train.diffgrad import DiffGradNorm
    from camradepth_tpu_torch.train.step import train_step
    from camradepth_tpu_torch.train.trainer import step_generator

    dev = resolve_device(device)
    cfg = preset("base")
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, remat_encoder=True,
                                  remat_decoder=True),
        train=dataclasses.replace(cfg.train, batch_size=TRAIN_BATCH,
                                  pad_microbatch_to=8))
    h, w = cfg.model.img_size
    model = create_model(cfg.model, device=dev, seed=0, train=True)
    opt = DiffGradNorm(model.parameters(), lr=cfg.train.learning_rate)
    g = torch.Generator().manual_seed(1)
    micro = {"features": torch.randn((TRAIN_BATCH, h, w, 7), generator=g),
             "gt_depth": torch.randn((TRAIN_BATCH, h, w),
                                     generator=g).abs() * 0.1}
    micro = {k: v.to(dev) for k, v in micro.items()}
    count = itertools.count()

    def step():
        i = next(count)
        train_step(cfg, model, opt, [micro], [step_generator(dev, 0, 0, i, 0)],
                   cfg.train.learning_rate)

    for _ in range(TRAIN_WARMUP):
        step()
    ms = _elapsed_ms(step, steps, dev)
    return {"train_step_ms_batch6": round(ms, 1),
            "train_frames_per_sec": round(TRAIN_BATCH * 1e3 / ms, 1)}


def bench_line(train: bool = False, device="cuda") -> Dict:
    """The benchmark's result dict (what :func:`main` prints)."""
    from camradepth_tpu_torch import resolve_device
    from camradepth_tpu_torch.config import preset

    dev = resolve_device(device)
    label = device_label(dev)
    cfg = preset("base")
    base = run_bench(cfg, dev)
    variant = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    tpu_decoder=True))
    tv = run_bench(variant, dev)
    fps, base_fps = base["fps"], baseline_fps()
    out = {
        "metric": METRIC,
        "value": round(fps, 1),
        "unit": UNIT,
        "vs_baseline": round(fps / base_fps, 2),
        "batch1_latency_ms": round(base["batch1_latency_ms"], 2),
        "batch": BATCH,
        "device": label,
        **{k: base[k] for k in ("gflops_per_frame", "achieved_tflops",
                                "attainable_ms_per_frame", "roofline_pct")},
        "launches_per_forward": base["launches_per_forward"],
        "tpu_variant_fps": round(tv["fps"], 1),
        "tpu_variant_vs_baseline": round(tv["fps"] / base_fps, 2),
        "tpu_variant_batch1_latency_ms": round(tv["batch1_latency_ms"], 2),
        "tpu_variant_roofline_pct": tv["roofline_pct"],
        "tpu_variant_gflops_per_frame": tv["gflops_per_frame"],
        "tpu_variant_launches_per_forward": tv["launches_per_forward"],
    }
    if train:
        out.update(train_fields(dev))
    return out


def main(argv=None) -> int:
    """Print the benchmark's one JSON line; on any failure one line with
    ``"value": null`` and the error, and exit code 1."""
    argv = sys.argv[1:] if argv is None else argv
    try:
        line = bench_line(train="--train" in argv)
    except Exception as e:  # the one line must come out, whatever failed
        print(json.dumps({"metric": METRIC, "value": None, "unit": UNIT,
                          "error": f"{type(e).__name__}: {e}"[:500]}),
              flush=True)
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
