"""Bicubic x2 upsampling over NHWC with PyTorch's semantics.

Counterpart of ``camradepth_tpu/ops/resize.py``: the reference decoder's
``nn.Upsample(scale_factor=2, mode='bicubic')`` (a = -0.75, edge
replication, align_corners=False). For an exact x2 the filter has two
static 4-tap phases:

  even outputs (o=2k):   taps (k-2, k-1, k, k+1), weights W(1.75), W(0.75), W(0.25), W(1.25)
  odd  outputs (o=2k+1): taps (k-1, k, k+1, k+2), the same weights reversed

H is filtered first, then W; each axis accumulates in fp32 and rounds to
the input dtype between the axes.

:func:`upsample_bicubic_x2` is the kernel's wrapper. On a CUDA tensor it
launches the Hopper kernel ``csrc/upsample_bicubic_x2.cu``; on a CPU tensor
it runs :func:`upsample_bicubic_x2_reference`, the plain PyTorch version.
Only the forward is ported; the backward comes with training. Until then a
CUDA input that requires a gradient, with gradients enabled, raises instead
of returning a result detached from the graph; the CPU path stays
differentiable.
"""

from __future__ import annotations

import torch

from camradepth_tpu_torch.ops import _build


def _cubic_w(x: float, a: float = -0.75) -> float:
    x = abs(x)
    if x <= 1.0:
        return (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0
    if x < 2.0:
        return a * x**3 - 5.0 * a * x**2 + 8.0 * a * x - 4.0 * a
    return 0.0


# Static per-phase weights; all four are exact in fp32.
W_EVEN = (_cubic_w(1.75), _cubic_w(0.75), _cubic_w(0.25), _cubic_w(1.25))
W_ODD = W_EVEN[::-1]


def _upsample_axis_x2(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Doubles ``axis`` (1 = H, 2 = W) of an NHWC tensor: edge-pad by 2,
    four shifted slices per phase with fp32 accumulation in tap order,
    phases interleaved, result in the input dtype."""
    n = x.shape[axis]
    first = x.narrow(axis, 0, 1)
    last = x.narrow(axis, n - 1, 1)
    xp = torch.cat([first, first, x, last, last], dim=axis).float()

    def phase(weights, start):
        acc = xp.narrow(axis, start, n) * weights[0]
        for t in range(1, 4):
            acc = acc + xp.narrow(axis, start + t, n) * weights[t]
        return acc

    out = torch.stack([phase(W_EVEN, 0), phase(W_ODD, 1)], dim=axis + 1)
    shape = list(x.shape)
    shape[axis] *= 2
    return out.reshape(shape).to(x.dtype)


def upsample_bicubic_x2_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version over [B, H, W, C] (``camradepth_tpu/ops/resize.py:
    40-122``)."""
    return _upsample_axis_x2(_upsample_axis_x2(x, 1), 2)


def upsample_bicubic_x2(x: torch.Tensor) -> torch.Tensor:
    """Bicubic x2 over the spatial axes of NHWC ``x`` [B, H, W, C] (bf16 or
    fp32, any C); returns [B, 2H, 2W, C] in ``x.dtype``."""
    if x.device.type == "cpu":
        return upsample_bicubic_x2_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"x must lie on a CUDA device or the CPU, got "
                         f"{x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"dtype must be one of {list(_SUFFIX)}, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"need NHWC [B,H,W,C], got {tuple(x.shape)}")
    _build.refuse_autograd("upsample_bicubic_x2", x)
    b, h, w, c = x.shape
    x = x.contiguous()
    y = torch.empty((b, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    _build.launch("upsample_bicubic_x2",
                  f"upsample_bicubic_x2_{_SUFFIX[x.dtype]}", x.device,
                  x.data_ptr(), y.data_ptr(), b, h, w, c)
    upsample_bicubic_x2.launches += 1
    return y


upsample_bicubic_x2.launches = 0
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
