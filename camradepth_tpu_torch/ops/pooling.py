"""The GT inverse-depth min-pool pyramid.

Counterpart of ``camradepth_tpu/ops/pooling.py:18-51``. The reference
builds its deep-supervision depth targets by min-pooling the sparse
inverse-depth GT with 0 as "no data" (dataloader.py:213-222: ``x[x==0]=255;
x=-maxpool3x3s2p1(-x); x[x==255]=0``). XLA computes it outside any Pallas
kernel, so the port has no kernel here: a 3x3 stride-2 max-pool of the
negated map, padded with -inf, in torch.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_SENTINEL = 255.0


def minpool_sparse(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 min-pool treating 0 as "no data".

    Args:
      x: [..., H, W] sparse map with 0 = invalid; valid values must be
        < 255 (normalized inverse depth lies in (0, 1]).
    Returns:
      [..., ceil(H/2), ceil(W/2)] min-pooled map in ``x.dtype``, 0 where
      the window held no valid pixel.
    """
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    xf = x.float().reshape(-1, 1, h, w)
    filled = torch.where(xf == 0, torch.full_like(xf, _SENTINEL), xf)
    # max_pool2d pads with -inf, so the padded taps never win
    pooled = -F.max_pool2d(-filled, kernel_size=3, stride=2, padding=1)
    out = torch.where(pooled == _SENTINEL, torch.zeros_like(pooled), pooled)
    return out.reshape(*lead, *out.shape[-2:]).to(x.dtype)


def minpool_pyramid(x: torch.Tensor, levels: int = 3) -> Tuple[torch.Tensor,
                                                                ...]:
    """The deep-supervision pyramid (dataloader.py:255-257): maps at 1/2,
    1/4, 1/8 resolution for ``levels`` = 3."""
    out = []
    cur = x
    for _ in range(levels):
        cur = minpool_sparse(cur)
        out.append(cur)
    return tuple(out)
