"""Fused 3x3 convolution + GroupNorm statistics over NHWC sources.

Counterpart of ``camradepth_tpu/ops/conv_fused.py``: a SAME, bias-free 3x3
convolution over the channel concat of its :class:`Source` s, each of them
optionally ``gelu(x * scale + shift)`` on load (a GroupNorm affine folded
per (batch, channel) by :func:`gn_affine_from_stats`), accumulated in fp32.
It returns the raw output in the activation dtype plus the fp32 per-(batch,
channel) sum and sum of squares of that output, so the next GroupNorm needs
no extra pass over the image. Inference only, as in the JAX package.

:func:`conv3x3_fused` is the kernel's wrapper. On CUDA tensors it launches
the Hopper kernel ``csrc/conv3x3_fused.cu``; on CPU tensors it runs
:func:`conv3x3_reference`, the plain PyTorch version. The public layout is
the JAX package's: NHWC sources and HWIO weights ``[3, 3, K, N]`` with K the
sum of the sources' valid channels.

One deliberate difference: the JAX kernel pads its output to a multiple of
128 channels, a TPU DMA contract (``conv_fused.py:18-21``, ``:416-422``),
and takes affine sources only with 128-aligned channel counts (``:371-375``).
The port returns ``[B, H, W, N]`` unpadded and takes any channel count. It
still honours ``Source.valid``, so a padded source from JAX-style code is
read correctly.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from camradepth_tpu_torch.ops import _build
from camradepth_tpu_torch.ops.gelu import gelu_reference

MAX_SOURCES = 4  # kMaxSources in csrc/conv3x3_fused.cu
TILE = 16  # output tile side of the kernel (kTile), for its stats scratch


class Source(NamedTuple):
    """One channel-concat member of a fused conv's input.

    ``x`` is raw (pre-GroupNorm) when ``scale``/``shift`` are set: the conv
    applies ``gelu(x * scale + shift)`` on load, multiply and add each
    rounded to ``x.dtype`` as ``ops/groupnorm.py`` applies its folded affine.
    With ``scale=None`` the source is read as it is, or through GELU alone.

    ``valid``: the number of meaningful leading channels when ``x`` carries
    padding; None means all of them.
    """

    x: torch.Tensor                       # [B, H, W, C]
    scale: Optional[torch.Tensor] = None  # [B, valid] folded GN scale
    shift: Optional[torch.Tensor] = None  # [B, valid] folded GN shift
    gelu: bool = False
    valid: Optional[int] = None


def _valid(src: Source) -> int:
    return src.x.shape[-1] if src.valid is None else src.valid


def _transformed(src: Source) -> torch.Tensor:
    """The source as the conv reads it: valid channels, affine, GELU."""
    v = src.x[..., : _valid(src)]
    if src.scale is not None:
        v = (v * src.scale.to(v.dtype)[:, None, None, :]
             + src.shift.to(v.dtype)[:, None, None, :])
    if src.gelu:
        v = gelu_reference(v)
    return v


def conv3x3_reference(
    sources: Sequence[Source], weights: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version (``camradepth_tpu/ops/conv_fused.py:389-413``): the
    transformed sources concatenated, the weights rounded to the activation
    dtype, and the conv taken in fp32 with TF32 off, so that bf16 products
    are exact and summed in fp32 as the kernel sums them. The statistics
    come from the fp32 output before it is rounded, as the kernel's do.

    Returns ``(raw [B, H, W, N] in x.dtype, sum [B, N] fp32, sqsum [B, N]
    fp32)``.
    """
    parts = [_transformed(s) for s in sources]
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    w = weights.to(x.dtype).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = F.conv2d(x.float().permute(0, 3, 1, 2), w, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    sums = out.sum(dim=(2, 3))
    sqsums = (out * out).sum(dim=(2, 3))
    raw = out.permute(0, 2, 3, 1).to(x.dtype).contiguous()
    return raw, sums, sqsums


def conv3x3_fused(
    sources: Sequence[Source], weights: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SAME 3x3 conv over the channel concat of ``sources`` (each optionally
    GroupNorm-affine + GELU on load).

    Args:
      sources: 1 to 4 :class:`Source` s of one shape [B, H, W, *], one
        dtype (bf16 or fp32) and one device; CPU tensors take the plain
        version.
      weights: HWIO [3, 3, K, N], K = sum of the valid channels; cast to the
        activation dtype, as the JAX package does.
    Returns:
      ``(raw [B, H, W, N] in the activation dtype, channel sum [B, N] fp32,
      channel sum of squares [B, N] fp32)`` of the raw output.

    The first bf16 call on a card fills the kernel's GELU table there and
    waits for it (a stream synchronisation): make it outside a CUDA graph
    capture.
    """
    b, h, w, k, n = _check(sources, weights)
    if sources[0].x.device.type == "cpu":
        return conv3x3_reference(sources, weights)
    dtype, dev = sources[0].x.dtype, sources[0].x.device
    tensors = [weights] + [t for s in sources
                           for t in (s.x, s.scale, s.shift) if t is not None]
    _build.refuse_autograd("conv3x3_fused", *tensors)

    keep = []  # the contiguous tensors whose pointers the kernel reads
    ptrs, meta = [], []
    for s in sources:
        x = s.x.contiguous()
        aff = [] if s.scale is None else [s.scale.to(dtype).contiguous(),
                                          s.shift.to(dtype).contiguous()]
        keep += [x, *aff]
        ptrs += [x.data_ptr()] + ([t.data_ptr() for t in aff] or [None, None])
        meta += [x.shape[-1], _valid(s), int(bool(s.gelu))]
    wt = weights.to(dtype).contiguous()
    out = torch.empty((b, h, w, n), dtype=dtype, device=dev)
    n_tiles = -(-h // TILE) * -(-w // TILE)
    partial = torch.empty((2, b, n_tiles, n), dtype=torch.float32, device=dev)
    stats = torch.empty((2, b, n), dtype=torch.float32, device=dev)
    _build.launch("conv3x3_fused", f"conv3x3_fused_{_SUFFIX[dtype]}", dev,
                  (ctypes.c_void_p * len(ptrs))(*ptrs),
                  (ctypes.c_int * len(meta))(*meta), len(sources),
                  wt.data_ptr(), out.data_ptr(), partial.data_ptr(),
                  stats.data_ptr(), b, h, w, k, n)
    conv3x3_fused.launches += 1
    return out, stats[0], stats[1]


conv3x3_fused.launches = 0
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check(sources: Sequence[Source], weights: torch.Tensor):
    """Raise on what the kernel does not take; returns (B, H, W, K, N)."""
    if not 0 < len(sources) <= MAX_SOURCES:
        raise ValueError(f"need 1 to {MAX_SOURCES} sources, got "
                         f"{len(sources)}")
    tensors = [weights] + [t for s in sources
                           for t in (s.x, s.scale, s.shift) if t is not None]
    dev = sources[0].x.device
    if dev.type not in ("cpu", "cuda") or any(t.device != dev
                                              for t in tensors):
        raise ValueError(
            "sources, affines and weights must all lie on the CPU or all "
            "on one CUDA device, got "
            f"{sorted({str(t.device) for t in tensors})}"
        )
    dtype = sources[0].x.dtype
    if dtype not in _SUFFIX or any(s.x.dtype != dtype for s in sources):
        raise TypeError(f"sources must share a dtype in {list(_SUFFIX)}, "
                        f"got {[s.x.dtype for s in sources]}")
    b, h, w = sources[0].x.shape[:3]
    k = 0
    for s in sources:
        if s.x.ndim != 4 or tuple(s.x.shape[:3]) != (b, h, w):
            raise ValueError(f"sources must be NHWC of one [B, H, W] = "
                             f"{(b, h, w)}, got {tuple(s.x.shape)}")
        if not 0 < _valid(s) <= s.x.shape[-1]:
            raise ValueError(f"valid={s.valid} outside 1..{s.x.shape[-1]}")
        if (s.scale is None) != (s.shift is None):
            raise ValueError("scale and shift come together")
        if s.scale is not None and not (
                tuple(s.scale.shape) == tuple(s.shift.shape)
                == (b, _valid(s))):
            raise ValueError(f"scale and shift must be [B, valid] = "
                             f"{(b, _valid(s))}")
        k += _valid(s)
    if weights.ndim != 4 or tuple(weights.shape[:3]) != (3, 3, k):
        raise ValueError(f"weights must be HWIO [3, 3, {k}, N], got "
                         f"{tuple(weights.shape)}")
    return b, h, w, k, weights.shape[3]


def gn_affine_from_stats(
    ch_sum: torch.Tensor,
    ch_sqsum: torch.Tensor,
    count: int,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Folded per-(batch, channel) GroupNorm scale and shift, fp32 [B, C],
    from raw-output channel statistics (``count`` = H*W elements per
    channel), with ``ops/groupnorm.py``'s math
    (``camradepth_tpu/ops/conv_fused.py:425-449``)."""
    b, c = ch_sum.shape
    gsize = c // num_groups
    gs = ch_sum.float().reshape(b, num_groups, gsize).sum(-1)
    gq = ch_sqsum.float().reshape(b, num_groups, gsize).sum(-1)
    n = count * gsize
    mean = gs / n
    var = (gq / n - mean * mean).clamp_min(0.0)
    inv = torch.reciprocal(torch.sqrt(var + eps))  # [B, G]
    inv = inv.repeat_interleave(gsize, dim=-1)  # [B, C]
    mean = mean.repeat_interleave(gsize, dim=-1)
    scale = inv * gamma.float()[None]
    shift = beta.float()[None] - mean * scale
    return scale, shift
