"""Test-split metric computation, in torch on the device of its inputs.

The package's own copy of ``camradepth_tpu/evaluation/metrics.py``: the
reference test harness math (runner.py:394-519), batched, one row per
frame. Parity notes kept from the JAX package:

- All depth metrics are computed in *inverse-depth* space: pred/gt are
  ``max_depth * (1 - d/max_depth)`` (runner.py:442-465). MAE/RMSE are
  invariant under the affine flip but REL is relative to (100 - d).
- The second band applies ``gt[gt < max_distances[1]] = 0`` in inverse
  space (runner.py:477), i.e. it *keeps* inverse >= 50 <=> true depth
  <= 50 m.
- Frames with no valid pixels in a band are skipped: NaN here, averaged
  with ``nanmean`` by the harness, as the reference's ``continue``.

Also true-depth-space metrics at configurable caps (50/70/80 m), from the
decoded depth. Everything is fp32.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def _frame_stats(err_abs, err_sq, rel, valid):
    """Per-frame masked means over the pixel axes; NaN when empty."""
    n = valid.sum(dim=(1, 2))
    safe_n = n.clamp_min(1.0)
    mae = (err_abs * valid).sum(dim=(1, 2)) / safe_n
    rmse = torch.sqrt((err_sq * valid).sum(dim=(1, 2)) / safe_n)
    rel_m = (rel * valid).sum(dim=(1, 2)) / safe_n
    nan = torch.full_like(mae, float("nan"))
    empty = n == 0
    return (
        torch.where(empty, nan, mae),
        torch.where(empty, nan, rmse),
        torch.where(empty, nan, rel_m),
        n,
    )


def _band(pred_m, gt_b, out, cap):
    valid = (gt_b > 0).float()
    err = pred_m - gt_b
    rel = err.abs() / torch.where(gt_b > 0, gt_b, torch.ones_like(gt_b))
    mae, rmse, relm, n = _frame_stats(err.abs(), err * err, rel, valid)
    out[f"mae_{cap}"] = mae
    out[f"rmse_{cap}"] = rmse
    out[f"rel_{cap}"] = relm
    out[f"n_{cap}"] = n


def depth_metrics_inverse(
    pred: torch.Tensor,
    gt: torch.Tensor,
    max_depth: float = 100.0,
    max_distances: Sequence[float] = (100.0, 50.0),
) -> Dict[str, torch.Tensor]:
    """Reference-parity metrics in inverse space
    (``camradepth_tpu/evaluation/metrics.py:44-87``).

    Args:
      pred: [B, H, W] network output in [0, 1] (clipped here).
      gt:   [B, H, W] inverse-encoded GT in [0, 1], 0 = invalid.
    Returns per-frame [B] rows mae_k/rmse_k/rel_k/n_k for each band cap k,
    NaN for empty frames.
    """
    pred_m = pred.float().clamp(0.0, 1.0) * max_depth
    gt_m = gt.float() * max_depth
    out: Dict[str, torch.Tensor] = {}
    # band 0: drop gt above cap0 (a no-op at cap 100), keep valid
    zero = torch.zeros_like(gt_m)
    gt0 = torch.where(gt_m > max_distances[0], zero, gt_m)
    _band(pred_m, gt0, out, int(max_distances[0]))
    # band 1: additionally zero gt below cap1 IN INVERSE SPACE
    gt1 = torch.where(gt0 < max_distances[1], zero, gt0)
    _band(pred_m, gt1, out, int(max_distances[1]))
    return out


def depth_metrics_true(
    pred: torch.Tensor,
    gt: torch.Tensor,
    max_depth: float = 100.0,
    caps: Sequence[float] = (50.0, 70.0, 80.0),
) -> Dict[str, torch.Tensor]:
    """True-depth-space metrics at distance caps
    (``camradepth_tpu/evaluation/metrics.py:90-114``): decode
    d = max_depth - inv and score |pred_d - gt_d| on valid pixels with
    gt_d <= cap."""
    pred_inv = pred.float().clamp(0.0, 1.0) * max_depth
    gt_inv = gt.float() * max_depth
    gt_d = torch.where(gt_inv > 0, max_depth - gt_inv,
                       torch.zeros_like(gt_inv))
    pred_d = max_depth - pred_inv
    out: Dict[str, torch.Tensor] = {}
    for cap in caps:
        valid = ((gt_d > 0) & (gt_d <= cap)).float()
        err = pred_d - gt_d
        rel = err.abs() / torch.where(gt_d > 0, gt_d, torch.ones_like(gt_d))
        mae, rmse, relm, _ = _frame_stats(err.abs(), err * err, rel, valid)
        out[f"true_mae_{int(cap)}"] = mae
        out[f"true_rmse_{int(cap)}"] = rmse
        out[f"true_rel_{int(cap)}"] = relm
    return out


def jaccard_index(
    logits: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    ignore_index: int = 255,
) -> torch.Tensor:
    """Per-frame macro IoU over present classes (torchmetrics JaccardIndex
    with ignore_index, runner.py:433-437;
    ``camradepth_tpu/evaluation/metrics.py:117-133``).

    Args:
      logits: [B, H, W, num_classes]
      target: [B, H, W] int labels
    Returns [B] mean IoU (NaN if no class present).
    """
    return jaccard_index_labels(logits.argmax(dim=-1), target, num_classes,
                                ignore_index)


def jaccard_index_labels(
    pred: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    ignore_index: int = 255,
) -> torch.Tensor:
    """:func:`jaccard_index` on label maps [B, H, W]
    (``camradepth_tpu/evaluation/metrics.py:136-168``): a per-frame
    confusion matrix of the non-ignored pixels."""
    b = pred.shape[0]
    valid = target != ignore_index
    t = torch.where(valid, target, torch.zeros_like(target)).long()
    idx = (t * num_classes + pred.long()).reshape(b, -1)
    cm = torch.zeros(b, num_classes * num_classes, dtype=torch.float32,
                     device=pred.device)
    cm.scatter_add_(1, idx, valid.reshape(b, -1).float())
    cm = cm.reshape(b, num_classes, num_classes)
    tp = torch.diagonal(cm, dim1=1, dim2=2)
    fp = cm.sum(dim=1) - tp
    fn = cm.sum(dim=2) - tp
    denom = tp + fp + fn
    iou = tp / denom.clamp_min(1.0)
    present = denom > 0
    k = present.sum(dim=1)
    mean = torch.where(present, iou, torch.zeros_like(iou)).sum(dim=1) / (
        k.clamp_min(1))
    return torch.where(k > 0, mean, torch.full_like(mean, float("nan")))
