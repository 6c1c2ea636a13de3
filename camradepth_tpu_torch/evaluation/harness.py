"""Test-mode evaluation: the reference metric report + throughput.

The package's own copy of the dense path of
``camradepth_tpu/evaluation/harness.py``: per-frame metrics at both caps,
the rain (edge) / sunny RMSE split by file name, and the time per frame
(runner.py:394-519), and the seg IoU of a supervised seg branch, batched.
The device computes a whole batch's
per-frame metric rows under ``torch.inference_mode``, and only [B] vectors
cross to the host. Batches are copied to the device ahead of use on a
worker thread (pinned memory, non-blocking), so host artifact reads overlap
device compute. Compact wire batches (``data/wire.py``) are decoded on
the device inside the test step. A serving artifact (``interop/export.py``)
is scored through :func:`make_artifact_test_step`.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from camradepth_tpu_torch import resolve_device
from camradepth_tpu_torch.config import ExperimentConfig
from camradepth_tpu_torch.data import wire
from camradepth_tpu_torch.evaluation import metrics as M
from camradepth_tpu_torch.utils.prefetch import prefetch_iter

# Wall-clock-derived report keys: never metric-compared across runs.
TIMING_KEYS = (
    "wall_s",
    "time_per_frame_s",
    "frames_per_sec_end_to_end",
    "frames_per_sec_steady",
    "time_per_frame_steady_s",
)


def make_test_step(cfg: ExperimentConfig, model):
    """Returns ``test_step(batch) -> per-frame metric rows [B]``, ``batch``
    holding device tensors ``features`` [B, H, W, C] and ``gt_depth``
    [B, H, W], and for a supervised seg branch ``seg`` [B, H, W], the
    labels its ``iou`` row scores, or the keys of a compact wire batch,
    which it decodes first (``camradepth_tpu/evaluation/harness.py:
    36-63``)."""

    def test_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            if wire.is_wire_micro(batch):
                batch = wire.decode_wire_micro(batch)
            pred = model(batch["features"])
            depth = pred["depth"]["final_depth"][..., 0]
            rows = M.depth_metrics_inverse(
                depth, batch["gt_depth"], cfg.data.max_depth,
                cfg.data.max_distances,
            )
            rows.update(M.depth_metrics_true(depth, batch["gt_depth"],
                                             cfg.data.max_depth))
            if cfg.model.supervised_seg:
                rows["iou"] = M.jaccard_index(pred["seg"]["final_seg"],
                                              batch["seg"],
                                              cfg.model.num_classes)
        return rows

    return test_step


def make_artifact_test_step(cfg: ExperimentConfig, call, header):
    """Metric rows from a serving artifact's outputs
    (``camradepth_tpu/evaluation/harness.py:66-97``): the artifact gives
    depth in metres (unless exported raw) and argmax seg labels, so the
    depth is encoded back to the inverse space the reference metrics take
    (the decode is affine) and the IoU scores the label maps. What is
    scored is the program that will serve."""
    max_depth = float(header["max_depth"])
    decode = bool(header["decode_depth"])

    def test_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = call(batch["features"])
        with torch.inference_mode():
            depth = out["depth"]
            enc = (1.0 - depth / max_depth) if decode else depth
            rows = M.depth_metrics_inverse(
                enc, batch["gt_depth"], cfg.data.max_depth,
                cfg.data.max_distances,
            )
            rows.update(M.depth_metrics_true(enc, batch["gt_depth"],
                                             cfg.data.max_depth))
            if (cfg.model.supervised_seg and out["seg"] is not None
                    and "seg" in batch):
                rows["iou"] = M.jaccard_index_labels(
                    out["seg"], batch["seg"], cfg.model.num_classes)
        return rows

    return test_step


def evaluate(
    cfg: ExperimentConfig,
    model,
    loader,
    device="cuda",
    test_step=None,
) -> Dict[str, float]:
    """Run the full test split through ``model`` (a port ``CamRaDepth`` on
    ``device``), or through ``test_step`` when given (the artifact path,
    :func:`make_artifact_test_step`; ``model`` is then None); returns the
    reference report plus the true-depth metrics and throughput
    (``camradepth_tpu/evaluation/harness.py:100-181``). Two batches are
    loaded and copied ahead. Raises when ``device`` is CUDA and no card
    is there."""
    dev = resolve_device(device)
    if test_step is None:
        test_step = make_test_step(cfg, model)

    keys = ("features", "gt_depth") + wire.WIRE_KEYS + (
        ("seg",) if cfg.model.supervised_seg else ())

    def _prepare(batch):
        out = {}
        for k in keys:
            if k not in batch:
                continue
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            if dev.type == "cuda":
                t = t.pin_memory().to(dev, non_blocking=True)
            out[k] = t
        return batch, out

    all_rows = []
    names = []
    n_frames = 0
    t_start = time.perf_counter()
    t_first_done = None
    frames_first = 0
    for batch, dev_batch in prefetch_iter(loader, 2, _prepare):
        rows = {k: v.cpu().numpy() for k, v in test_step(dev_batch).items()}
        valid = batch["valid"].astype(bool)
        all_rows.append({k: v[valid] for k, v in rows.items()})
        names.extend(loader.frames.name(int(i))
                     for i in batch["index"][valid])
        n_frames += int(valid.sum())
        if t_first_done is None:
            # the first batch absorbs the warm-up (the kernels' build on
            # the card): mark it so a small split can report a steady rate
            t_first_done = time.perf_counter()
            frames_first = n_frames
    wall = time.perf_counter() - t_start

    cat = {k: np.concatenate([r[k] for r in all_rows])
           for k in all_rows[0]}
    cap0 = int(cfg.data.max_distances[0])
    rain = np.array(["rain" in n for n in names])
    rmse0 = cat[f"rmse_{cap0}"]
    report: Dict[str, float] = {}
    for k, v in cat.items():
        if not k.startswith("n_"):
            report[k] = float(np.nanmean(v))
    report["rmse_edge"] = (float(np.nanmean(rmse0[rain])) if rain.any()
                           else float("nan"))
    report["rmse_sunny"] = (float(np.nanmean(rmse0[~rain]))
                            if (~rain).any() else float("nan"))
    report["frames"] = float(n_frames)
    report["wall_s"] = wall
    report["time_per_frame_s"] = wall / max(1, n_frames)
    report["frames_per_sec_end_to_end"] = n_frames / wall
    steady_frames = n_frames - frames_first
    steady_wall = wall - (t_first_done - t_start)
    if steady_frames > 0 and steady_wall > 0:
        report["frames_per_sec_steady"] = steady_frames / steady_wall
        report["time_per_frame_steady_s"] = steady_wall / steady_frames
    return report


def format_report(cfg: ExperimentConfig, report: Dict[str, float]) -> str:
    """Reference report structure (runner.py:494-519,
    ``camradepth_tpu/evaluation/harness.py:184-224``): both cap blocks open
    with the mean inference time, then RMSE/MAE/REL; the first block also
    carries the sunny/edge split and, for a supervised seg branch, IoU.
    Then the true-depth caps."""
    cap0, cap1 = (int(c) for c in cfg.data.max_distances[:2])
    lines = [f"==== max depth {cap0} ===="]
    if "time_per_frame_s" in report:
        lines.append(f"inference time: {report['time_per_frame_s']:.6f} s")
    lines += [
        f"RMSE: {report[f'rmse_{cap0}']:.4f} m (inverse space)",
        f"sunny RMSE:       {report['rmse_sunny']:.4f} m",
        f"edge (rain) RMSE: {report['rmse_edge']:.4f} m",
        f"MAE:  {report[f'mae_{cap0}']:.4f} m",
        f"REL:  {report[f'rel_{cap0}']:.4f}",
    ]
    if "iou" in report:
        lines.append(f"IoU: {report['iou']:.4f}")
    lines.append(f"==== max depth {cap1} ====")
    if "time_per_frame_s" in report:
        lines.append(f"inference time: {report['time_per_frame_s']:.6f} s")
    lines += [
        f"RMSE: {report[f'rmse_{cap1}']:.4f} m",
        f"MAE:  {report[f'mae_{cap1}']:.4f} m",
        f"REL:  {report[f'rel_{cap1}']:.4f}",
        "==== true-depth caps (north star) ====",
    ]
    for cap in (50, 70, 80):
        if f"true_rmse_{cap}" in report:
            lines.append(
                f"cap {cap} m: RMSE {report[f'true_rmse_{cap}']:.4f} "
                f"MAE {report[f'true_mae_{cap}']:.4f} "
                f"REL {report[f'true_rel_{cap}']:.4f}"
            )
    if "frames_per_sec_end_to_end" in report:
        lines.append(
            f"frames: {int(report['frames'])}  end-to-end "
            f"{report['frames_per_sec_end_to_end']:.2f} fps"
        )
    return "\n".join(lines)
