"""Softmax-free max-pool attention (DEST / Simplified attention).

Counterpart of ``camradepth_tpu/ops/attention.py``. The reference op
(simplified_attention.py:90-108) has one value token, the mean of x, shared
by every head, so the pre-projection output is rank 1: the head-summed,
max-pooled score s[b, n] times the channel mean vbar[b, c].

:func:`maxpool_attention_scores` is the kernel's wrapper. On a CUDA tensor
it launches the Hopper kernel ``csrc/maxpool_attention_scores.cu``; on a
CPU tensor it runs :func:`maxpool_attention_scores_reference`, the plain
PyTorch version. Only the forward is ported; the backward (argmax gather
and scatter-add) comes with training. Until then a CUDA input that
requires a gradient, with gradients enabled, raises instead of returning
a result detached from the graph; the CPU path stays differentiable.
"""

from __future__ import annotations

import torch

from camradepth_tpu_torch.ops import _build


def maxpool_attention_scores_reference(
    q: torch.Tensor, k: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """Plain version: s[b, n] = sum_h max_m <q_bnh, k_bmh> * scale, with the
    dot in fp32 and the scale applied before the max
    (``camradepth_tpu/ops/attention.py:32-48``). Returns fp32 [B, N]."""
    b, n, c = q.shape
    m = k.shape[1]
    d = c // num_heads
    qh = q.float().reshape(b, n, num_heads, d)
    kh = k.float().reshape(b, m, num_heads, d)
    scores = torch.einsum("bnhd,bmhd->bhnm", qh, kh)  # [B, h, N, M]
    return (scores * scale).amax(dim=-1).sum(dim=1)


def maxpool_attention_scores(
    q: torch.Tensor, k: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """Head-summed max-pooled attention scores.

    Args:
      q: [B, N, C] projected queries, bf16 or fp32.
      k: [B, M, C] projected keys, same dtype and device.
      num_heads: head count h; C must be divisible by h, and C/h <= 64 on
        the card.
      scale: score scale, (C/h) ** -0.5 in the model.
    Returns:
      fp32 [B, N].
    """
    if q.device.type == "cpu" and k.device.type == "cpu":
        return maxpool_attention_scores_reference(q, k, num_heads, scale)
    if q.device.type != "cuda" or k.device != q.device:
        raise ValueError(
            f"q and k must both be CUDA tensors of one device or both lie on "
            f"the CPU, got {q.device} and {k.device}"
        )
    if q.dtype != k.dtype or q.dtype not in _SUFFIX:
        raise TypeError(
            f"q and k must share a dtype in {list(_SUFFIX)}, got "
            f"{q.dtype} and {k.dtype}"
        )
    if q.ndim != 3 or k.ndim != 3 or q.shape[0] != k.shape[0] or (
        q.shape[2] != k.shape[2]
    ):
        raise ValueError(f"need q [B,N,C] and k [B,M,C], got {tuple(q.shape)}"
                         f" and {tuple(k.shape)}")
    b, n, c = q.shape
    m = k.shape[1]
    if c % num_heads or c // num_heads > 64 or m == 0:
        raise ValueError(
            f"the kernel takes head dims <= 64 and M > 0; got C={c}, "
            f"heads={num_heads}, M={m}"
        )
    _build.refuse_autograd("maxpool_attention_scores", q, k)
    q = q.contiguous()
    k = k.contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    _build.launch("maxpool_attention_scores",
                  f"maxpool_attention_scores_{_SUFFIX[q.dtype]}", q.device,
                  q.data_ptr(), k.data_ptr(), out.data_ptr(), b, n, m, c,
                  num_heads, float(scale))
    maxpool_attention_scores.launches += 1
    return out


maxpool_attention_scores.launches = 0
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def maxpool_attention(
    x: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    num_heads: int,
    scale: float,
) -> torch.Tensor:
    """Pre-projection attention output in rank-1 form
    (``camradepth_tpu/ops/attention.py:103-128``).

    Args:
      x: [B, N, C] input tokens (the value path: vbar = mean_n x).
      q: [B, N, C] projected queries.
      k: [B, M, C] projected keys.
    Returns:
      [B, N, C] = s[b, n] * vbar[b, c] in ``x.dtype``.
    """
    s = maxpool_attention_scores(q, k, num_heads, scale)
    vbar = x.float().mean(dim=1, keepdim=True)  # [B, 1, C]
    return (s[:, :, None] * vbar).to(x.dtype)
