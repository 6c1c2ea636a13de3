"""GroupNorm with fp32 statistics over the input dtype.

The algorithm of ``camradepth_tpu/ops/groupnorm.py:23-65``: E[x] and E[x^2]
per (batch, group) accumulated in fp32, the normalization and the affine
folded per (batch, channel) into one fp32 scale and shift, those cast to
the input dtype and applied as a multiply and an add. ``F.group_norm`` is not
used: in bf16 it normalizes in another order and rounds differently.

Under a spatial shard (``parallel/spatial.py``) each rank holds some rows:
Σx and Σx² per (batch, group) are summed in fp32 across the sp group and
divided by the whole image's element count, as GSPMD's cross-shard sums
do; the scale, shift and rounding are then the same.
"""

from __future__ import annotations

import torch

from camradepth_tpu_torch.parallel import spatial


def group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm over the last (channel) axis of ``[B, ..., C]``; statistics
    per (batch, group) over all non-batch axes, as torch's GroupNorm."""
    shape = x.shape
    b, c = shape[0], shape[-1]
    gsize = c // num_groups
    xg = x.reshape(b, -1, num_groups, gsize)
    shard = spatial.active()
    if shard is None:
        mean = xg.mean(dim=(1, 3), dtype=torch.float32)  # [B, G]
        mean2 = xg.float().square().mean(dim=(1, 3))
    else:
        sums = spatial.sum_across(torch.stack([
            xg.sum(dim=(1, 3), dtype=torch.float32),
            xg.float().square().sum(dim=(1, 3))]))
        mean, mean2 = sums / shard.global_count(xg.shape[1] * gsize)
    var = (mean2 - mean * mean).clamp_min(0.0)
    inv = torch.reciprocal(torch.sqrt(var + eps))
    inv_c = inv.repeat_interleave(gsize, dim=-1)  # [B, C]
    mean_c = mean.repeat_interleave(gsize, dim=-1)
    eff_scale = inv_c * scale.float()
    eff_shift = bias.float() - mean_c * eff_scale
    # multiply, then add, each rounded to x.dtype, as the JAX package does
    # (a fused multiply-add rounds once and differs by one bf16 ulp)
    y = (x.reshape(b, -1, c) * eff_scale[:, None, :].to(x.dtype)
         + eff_shift[:, None, :].to(x.dtype))
    return y.reshape(shape)
