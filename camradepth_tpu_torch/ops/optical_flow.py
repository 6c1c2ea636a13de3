"""Pyramidal Lucas-Kanade optical flow.

Counterpart of ``camradepth_tpu/ops/optical_flow.py``: the offline prep's
self-contained flow estimator (the reference computes im -> im_next flow
with RAFT, scripts/cal_flow.py): coarse-to-fine Lucas-Kanade with iterative
warping, Tikhonov-regularized 2x2 normal equations and box-filtered
structure tensors, each step the JAX package's (the box filter by
separable cumulative sums, the warp by clipped bilinear gathers, the flow
carried up a level by bilinear resize times 2). No JAX function here has
a Pallas original, so it runs as torch operations on the caller's device;
numpy in, numpy out.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from camradepth_tpu_torch import resolve_device


def _to_gray(im: torch.Tensor) -> torch.Tensor:
    if im.ndim == 3 and im.shape[-1] == 3:
        return im @ torch.tensor([0.299, 0.587, 0.114], dtype=im.dtype,
                                 device=im.device)
    return im[..., 0] if im.ndim == 3 else im


def _avgpool2(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape
    x = x[: h - h % 2, : w - w % 2]
    return x.reshape(h // 2, 2, w // 2, 2).mean((1, 3))


def _box(x: torch.Tensor, r: int) -> torch.Tensor:
    """Box filter by separable cumulative sums (window 2r+1, edge pad)."""
    k = 2 * r + 1
    pad = F.pad(x[None, None], (r, r, r, r), mode="replicate")[0, 0]
    c = torch.cumsum(pad, dim=0)
    c = torch.cat([c[k - 1:k], c[k:] - c[:-k]], dim=0)
    c2 = torch.cumsum(c, dim=1)
    out = torch.cat([c2[:, k - 1:k], c2[:, k:] - c2[:, :-k]], dim=1)
    return out / (k * k)


def _warp(im: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    h, w = im.shape
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=im.dtype, device=im.device),
        torch.arange(w, dtype=im.dtype, device=im.device), indexing="ij")
    xs = torch.clamp(xx + flow[..., 0], 0, w - 1)
    ys = torch.clamp(yy + flow[..., 1], 0, h - 1)
    x0 = torch.floor(xs).long()
    y0 = torch.floor(ys).long()
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    fx = xs - x0
    fy = ys - y0
    return (im[y0, x0] * (1 - fx) * (1 - fy) + im[y0, x1] * fx * (1 - fy)
            + im[y1, x0] * (1 - fx) * fy + im[y1, x1] * fx * fy)


def _lk_level(i1, i2, flow, radius: int, iters: int, reg: float = 1e-6):
    gy, gx = torch.gradient(i1)
    for _ in range(iters):
        it = _warp(i2, flow) - i1
        # Tikhonov-regularized 2x2 normal equations
        ixx = _box(gx * gx, radius) + reg
        iyy = _box(gy * gy, radius) + reg
        ixy = _box(gx * gy, radius)
        ixt = _box(gx * it, radius)
        iyt = _box(gy * it, radius)
        inv_det = 1.0 / (ixx * iyy - ixy * ixy)
        du = -(iyy * ixt - ixy * iyt) * inv_det
        dv = -(ixx * iyt - ixy * ixt) * inv_det
        flow = flow + torch.stack([du, dv], -1).clamp(-radius, radius)
    return flow


def _lk_pyramid(g1, g2, levels: int, radius: int, iters: int):
    pyr1, pyr2 = [g1], [g2]
    for _ in range(levels - 1):
        pyr1.append(_avgpool2(pyr1[-1]))
        pyr2.append(_avgpool2(pyr2[-1]))
    flow = g1.new_zeros((*pyr1[-1].shape, 2))
    for lvl in range(levels - 1, -1, -1):
        if lvl < levels - 1:
            # bilinear, half-pixel centres, as jax.image.resize upsamples
            up = F.interpolate(flow.permute(2, 0, 1)[None],
                               size=tuple(pyr1[lvl].shape),
                               mode="bilinear", align_corners=False)
            flow = up[0].permute(1, 2, 0) * 2.0
        flow = _lk_level(pyr1[lvl], pyr2[lvl], flow, radius, iters)
    return flow


@torch.no_grad()
def lk_flow(im1: np.ndarray, im2: np.ndarray, levels: int = 4,
            radius: int = 7, iters: int = 3, device="cuda") -> np.ndarray:
    """Per-pixel flow im1 -> im2 on ``device``. Takes HxWx3 uint8/float or
    HxW gray; returns [H, W, 2] float32 (dx, dy)."""
    dev = resolve_device(device)
    g1 = _to_gray(torch.as_tensor(np.asarray(im1, np.float32),
                                  device=dev) / 255.0)
    g2 = _to_gray(torch.as_tensor(np.asarray(im2, np.float32),
                                  device=dev) / 255.0)
    return _lk_pyramid(g1, g2, levels, radius, iters).cpu().numpy().astype(
        np.float32)
