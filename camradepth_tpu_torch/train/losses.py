"""Masked depth and segmentation losses.

Counterpart of ``camradepth_tpu/train/losses.py`` (the reference's
loss_funcs.py). Every loss is a fixed-shape masked mean,
sum(mask * f) / max(sum(mask), 1), as in the JAX package, and computes in
fp32.

The JAX package takes each mean over the global batch, however it is
sharded. Here a rank of a multi-device step holds its rows only, so the
losses that train (SmoothL1, the focal CE, and the MSE of the RMSE metric)
take a ``shard`` (``parallel/multihost.BatchShard``): the mask's count is
summed over the ranks, and so is the masked sum, through an all-reduce
whose gradient reaches each rank's own terms. The value is then the global
batch's mean on every rank, and the ranks' gradients add up to its
gradient, also when the ranks' valid-pixel counts differ (sparse lidar,
padded rows). The focal CE's transform, which follows the mean, sees the
global mean. Under spatially sharded training the shard is the sp group
(``parallel/spatial.RowShard``, whose ``sum`` and ``sum_grad`` are those
of a ``BatchShard``): each rank holds its rows of every map, the ranks'
rows are uneven (7 and 6 at /32 for 416x800), and the masked sums and
counts add up over the group alike. ``smoothness_loss`` is a mean of
per-sample means: over equal shares of the batch the global value is the
mean of the ranks' values, so it needs no shard (no training objective
calls it).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def masked_mean(values: torch.Tensor, mask: torch.Tensor,
                shard=None) -> torch.Tensor:
    """sum(mask * values) / max(sum(mask), 1), both sums over the global
    batch under a ``shard``."""
    num, den = torch.sum(values * mask), torch.sum(mask)
    if shard is not None:
        num, den = shard.sum_grad(num), shard.sum(den)
    return num / torch.clamp(den, min=1.0)


def masked_smooth_l1(pred: torch.Tensor, target: torch.Tensor,
                     beta: float = 1.0, shard=None) -> torch.Tensor:
    """SmoothL1 over target > 0 pixels (loss_funcs.py:77-91; beta 1)."""
    mask = (target > 0).float()
    diff = torch.abs(target - pred)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return masked_mean(loss, mask, shard)


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               shard=None) -> torch.Tensor:
    """MSE over target > 0 pixels (loss_funcs.py:36-46)."""
    mask = (target > 0).float()
    return masked_mean(torch.square(target - pred), mask, shard)


def masked_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mask = (target > 0).float()
    return masked_mean(torch.abs(target - pred), mask)


def masked_rmse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(masked_mse(pred, target))


def masked_huber(pred: torch.Tensor, target: torch.Tensor,
                 delta: float = 1.0) -> torch.Tensor:
    mask = (target > 0).float()
    diff = torch.abs(target - pred)
    loss = torch.where(diff < delta, 0.5 * diff * diff,
                       delta * (diff - 0.5 * delta))
    return masked_mean(loss, mask)


def masked_berhu(pred: torch.Tensor, target: torch.Tensor,
                 thresh: float = 0.2) -> torch.Tensor:
    """Reverse Huber with delta = thresh * max |err| over valid pixels
    (loss_funcs.py:130-154): strict inequalities, the L1 part zero above
    delta and the L2 part zero below it."""
    mask = target > 0
    diff = torch.abs(target - pred) * mask
    delta = thresh * torch.max(diff)
    zero = torch.zeros_like(diff)
    l1_part = torch.where(diff < delta, diff, zero)
    l2_part = torch.where(
        diff > delta, diff * diff / (2.0 * torch.clamp(delta, min=1e-12)),
        zero)
    return masked_mean(l1_part + l2_part, mask.float())


def masked_focal_ce(logits: torch.Tensor, target: torch.Tensor,
                    gamma: float = 2.0, ignore_index: int = 255,
                    shard=None) -> torch.Tensor:
    """Focal loss as in the reference (loss_funcs.py:14-34): cross entropy
    with ignore_index 255, mean-reduced FIRST, then the scalar focal
    transform (1 - exp(-ce))**gamma * ce, not a per-pixel weighting.

    Args:
      logits: [B, H, W, num_classes] (NHWC, class last).
      target: [B, H, W] int labels, 255 = ignore.
    """
    num_classes = logits.shape[-1]
    valid = (target != ignore_index) & (target >= 0) & (
        target < num_classes)
    safe_t = torch.where(valid, target, torch.zeros_like(target)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe_t[..., None])[..., 0]
    ce = masked_mean(nll, valid.float(), shard)
    pt = torch.exp(-ce)
    return (1.0 - pt) ** gamma * ce


def smoothness_loss(pred_depth: torch.Tensor,
                    image: torch.Tensor) -> torch.Tensor:
    """Edge-aware smoothness (loss_funcs.py:157-179). NHWC: pred_depth
    [B, H, W, 1], image [B, H, W, C]."""
    image = image.float()
    depth_mean = torch.mean(pred_depth, dim=(1, 2), keepdim=True)
    d = pred_depth / (depth_mean + 1e-7)
    gdx = torch.abs(d[:, :, :-1, :] - d[:, :, 1:, :])
    gdy = torch.abs(d[:, :-1, :, :] - d[:, 1:, :, :])
    gix = torch.mean(torch.abs(image[:, :, :-1, :] - image[:, :, 1:, :]), -1,
                     keepdim=True)
    giy = torch.mean(torch.abs(image[:, :-1, :, :] - image[:, 1:, :, :]), -1,
                     keepdim=True)
    gdx = gdx * torch.exp(-gix)
    gdy = gdy * torch.exp(-giy)
    return torch.mean(gdx) + torch.mean(gdy)


def multitask_loss(pred: dict, gt: dict, cfg, shard=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Deep-supervised multi-task objective (runner.py:197-215;
    ``camradepth_tpu/train/losses.py:111``): weights [1, 1, 1, .2, .2]
    over [depth_final, depth_stage4, depth_stage3, seg_final, seg_inter],
    normalized by their sum. The seg terms stay 0 until the port has the
    seg branches (ROADMAP queue 1 item 4); the seg-inter weight only
    inflates the denominator, as in every reference run.

    Args:
      pred: the model's output dict (NHWC).
      gt: {"depth": [B, H, W], "depth_stage4": [B, H/2, W/2],
           "depth_stage3": [B, H/4, W/4], "seg", "seg_inter"}.
      cfg: ExperimentConfig.
      shard: this rank's share of the global batch, or None; every term
        and metric is then the global batch's, the same on every rank.
    """
    w = cfg.train.loss_weights
    depth_final = pred["depth"]["final_depth"][..., 0]
    inter = pred["depth"]["intermediate_depths"]
    d4, d3 = inter[3][..., 0], inter[2][..., 0]

    l_final = masked_smooth_l1(depth_final, gt["depth"], shard=shard)
    l_d4 = masked_smooth_l1(d4, gt["depth_stage4"], shard=shard)
    l_d3 = masked_smooth_l1(d3, gt["depth_stage3"], shard=shard)

    zero = depth_final.new_zeros(())
    if cfg.model.supervised_seg and pred["seg"]["final_seg"] is not None:
        l_seg = masked_focal_ce(pred["seg"]["final_seg"], gt["seg"],
                                shard=shard)
        l_seg_i = (
            masked_focal_ce(pred["seg"]["intermediate_seg"], gt["seg_inter"],
                            shard=shard)
            if cfg.train.seg_inter_loss
            and pred["seg"]["intermediate_seg"] is not None
            else zero
        )
    else:
        l_seg = zero
        l_seg_i = zero

    total = (w[0] * l_final + w[1] * l_d4 + w[2] * l_d3 + w[3] * l_seg
             + w[4] * l_seg_i) / sum(w)
    rmse = torch.sqrt(masked_mse(depth_final, gt["depth"], shard)) * (
        cfg.data.max_depth)
    metrics = {
        "loss": total,
        "loss_depth_final": l_final,
        "loss_depth_stage4": l_d4,
        "loss_depth_stage3": l_d3,
        "loss_seg_final": l_seg,
        "loss_seg_inter": l_seg_i,
        "rmse_m": rmse,
    }
    return total, metrics
