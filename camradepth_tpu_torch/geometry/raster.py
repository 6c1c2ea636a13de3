"""Sparse z-buffered rasterization: point sets to min-depth-wins grids.

Counterpart of ``camradepth_tpu/geometry/raster.py``, which replaces the
reference's per-point raster loops (fuse_radar.py:182-197) with a
sort-based scatter. Here the scatter is ``scatter_reduce(..., "amin")``
twice, with no sort: the least depth of each pixel, then the least point
index among the points that reach it, so that of equal depths the first
point wins, as the JAX package's stable sorts and the reference's loop
decide. The winner's depth and payload are then copied, so every map
equals the JAX package's bit for bit. Inputs are tensors (on any device)
of fixed size with a validity mask.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def quantize_points(x, y, h_out: int, w_out: int, downsample_scale: float,
                    y_cutoff: int = 0):
    """Continuous full-resolution pixel coordinates -> downsampled integer
    coordinates with the reference's center-aligned mapping and clipping
    (fuse_radar.py:169-183): q = round((p + 0.5)/s - 0.5), clipped to the
    grid (before the y_cutoff crop). Returns (xi, yi, xq, yq)."""
    xq = ((x + 0.5) / downsample_scale - 0.5).clamp(0, w_out - 1)
    yq = ((y + 0.5) / downsample_scale - 0.5).clamp(0, h_out - 1)
    xi = torch.round(xq).to(torch.int32)
    yi = torch.round(yq).to(torch.int32)
    return xi, yi, xq, yq


def raster_min_depth(
    pix_id: torch.Tensor,
    depth: torch.Tensor,
    payload: Dict[str, torch.Tensor],
    num_pixels: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Min-depth-wins scatter of a flat point list.

    Args:
      pix_id: [N] int flattened pixel ids.
      depth: [N] float depths.
      payload: name -> [N] or [N, C] channels carried with the winner.
      num_pixels: H*W of the target grid.
      valid: [N] bool; invalid points are dropped.
    Returns:
      (depth_map [num_pixels], {name: [num_pixels] or [num_pixels, C]}),
      zeros where no point landed.
    """
    n = depth.shape[0]
    dev = depth.device
    pid = pix_id.long()
    if valid is not None:
        pid = torch.where(valid, pid, torch.full_like(pid, num_pixels))
    # the sentinel bucket num_pixels collects the invalid points
    dmin = torch.full((num_pixels + 1,), float("inf"), dtype=depth.dtype,
                      device=dev).scatter_reduce(0, pid, depth, "amin")
    index = torch.arange(n, device=dev)
    at_min = depth == dmin[pid]
    first = torch.full((num_pixels + 1,), n, dtype=torch.long,
                       device=dev).scatter_reduce(
        0, pid, torch.where(at_min, index, torch.full_like(index, n)),
        "amin")[:num_pixels]
    hit = first < n
    src = first.clamp_max(max(n - 1, 0))

    def gather(vals):
        out = torch.zeros((num_pixels,) + tuple(vals.shape[1:]),
                          dtype=vals.dtype, device=dev)
        if n:
            out[hit] = vals[src[hit]]
        return out

    return gather(depth), {k: gather(v) for k, v in payload.items()}


def rasterize_radar(x1, y1, depth1, times1, x2, y2, rcs, v_comp, valid,
                    downsample_scale: float = 2.0, y_cutoff: int = 34,
                    h_im: int = 900, w_im: int = 1600):
    """The radar raster (reference cal_depthMap_flow, fuse_radar.py:
    156-204): depth, flow, time, RCS and |v| maps on the downsampled grid,
    then the y-cutoff crop and the > 0.5 m/s moving-mask binarization. RCS
    takes the reference's +10 offset (fuse_radar.py:179-180). Inputs are
    [N] tensors with a validity mask; returns a dict of [H_out - y_cutoff,
    W_out] maps (flow [..., 2])."""
    h_out = int(h_im / downsample_scale)
    w_out = int(w_im / downsample_scale)
    xi1, yi1, xq1, yq1 = quantize_points(x1, y1, h_out, w_out,
                                         downsample_scale)
    # flow targets use the quantized-and-clipped continuous coordinates
    _, _, xq2, yq2 = quantize_points(x2, y2, h_out, w_out, downsample_scale)
    pix = yi1 * w_out + xi1
    payload = {
        "flow": torch.stack([xq2 - xq1, yq2 - yq1], dim=-1),
        "time": times1,
        "rcs": rcs + 10.0,
        "v_comp": v_comp,
    }
    depth_map, maps = raster_min_depth(pix, depth1, payload, h_out * w_out,
                                       valid)

    def grid(a):
        return a.reshape((h_out, w_out) + tuple(a.shape[1:]))[y_cutoff:]

    return {
        "depth": grid(depth_map),
        "flow": grid(maps["flow"]),
        "time": grid(maps["time"]),
        "rcs": grid(maps["rcs"]),
        "v_comp": (grid(maps["v_comp"]) > 0.5).to(torch.float32),
    }
