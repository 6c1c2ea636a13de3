"""Softmax-free max-pool attention (DEST / Simplified attention).

Counterpart of ``camradepth_tpu/ops/attention.py``. The reference op
(simplified_attention.py:90-108) has one value token, the mean of x, shared
by every head, so the pre-projection output is rank 1: the head-summed,
max-pooled score s[b, n] times the channel mean vbar[b, c].

:func:`maxpool_attention_scores` is the kernel's wrapper. On a CUDA tensor
it launches the Hopper kernel ``csrc/maxpool_attention_scores.cu``; on a
CPU tensor it runs the plain PyTorch version. Without gradients it calls
the operator ``torch.ops.camradepth.maxpool_attention_scores``
(``scores_op``), whose CUDA implementation launches the kernel and
counts it, so that an exported graph (``interop/export.py``) holds the
kernel and not its plain version. When gradients must flow it
goes through :class:`_Scores`, the port's form of the JAX custom VJP
(``camradepth_tpu/ops/attention.py:51-97``): the forward also keeps the
argmax [B, h, N] over the unscaled fp32 dots, and the backward is a gather
for dq and a scatter-add for dk, with no [B, h, N, M] tensor. On the card
those are the forward kernel's ``_argmax`` entry points and
``csrc/maxpool_attention_scores_bwd.cu`` (two launches, chunks sized by
:func:`scores_backward_plan`); on the CPU, the plain versions
:func:`maxpool_attention_scores_argmax_reference` and
:func:`maxpool_attention_scores_backward_reference`. Both are operators
too (``scores_argmax_op``, ``scores_backward_op``). Each of the three
operators has a ``torch.func.vmap`` rule that folds the vmapped dimension
into the batch (``[T, B, ...]`` to ``[T*B, ...]``, one launch for every
trial), and :class:`_Scores` takes its vmap rule from them, so a vmapped
trial step (``train/search.py``) differentiates through the kernels.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from camradepth_tpu_torch.ops import _build
from camradepth_tpu_torch.parallel import spatial


def _dots(q: torch.Tensor, k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The unscaled fp32 dots [B, h, N, M]."""
    b, n, c = q.shape
    m = k.shape[1]
    d = c // num_heads
    qh = q.float().reshape(b, n, num_heads, d)
    kh = k.float().reshape(b, m, num_heads, d)
    return torch.einsum("bnhd,bmhd->bhnm", qh, kh)


def maxpool_attention_scores_reference(
    q: torch.Tensor, k: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """Plain version: s[b, n] = sum_h max_m <q_bnh, k_bmh> * scale, with the
    dot in fp32 and the scale applied before the max
    (``camradepth_tpu/ops/attention.py:32-48``). Returns fp32 [B, N]."""
    return (_dots(q, k, num_heads) * scale).amax(dim=-1).sum(dim=1)


def maxpool_attention_scores_argmax_reference(
    q: torch.Tensor, k: torch.Tensor, num_heads: int, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward with its argmax: (s [B, N] fp32, amax
    [B, h, N] int32), the argmax taken over the unscaled fp32 dots, the
    first key on a tie (``jnp.argmax``, ``attention.py:46-47``)."""
    scores = _dots(q, k, num_heads)
    s = (scores * scale).amax(dim=-1).sum(dim=1)
    return s, scores.argmax(dim=-1).to(torch.int32)


def maxpool_attention_scores_backward_reference(
    q: torch.Tensor, k: torch.Tensor, amax: torch.Tensor, g: torch.Tensor,
    num_heads: int, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward, the mirror of ``_scores_bwd``
    (``camradepth_tpu/ops/attention.py:79-97``): gs = g * scale in fp32,
    dq = gs * k[amax] (gather), dk = the sum of gs * q over the tokens
    whose argmax is each key (scatter-add in fp32); both cast to the
    q/k dtype."""
    b, n, c = q.shape
    m = k.shape[1]
    d = c // num_heads
    qh = q.reshape(b, n, num_heads, d).transpose(1, 2)  # [B, h, N, d]
    kh = k.reshape(b, m, num_heads, d).transpose(1, 2)  # [B, h, M, d]
    gs = (g.float() * scale)[:, None, :]  # [B, 1, N]
    idx = amax.long()[..., None].expand(b, num_heads, n, d)
    k_sel = torch.gather(kh, 2, idx).float()  # [B, h, N, d]
    dq = (gs[..., None] * k_sel).transpose(1, 2).reshape(b, n, c)
    contrib = gs[..., None] * qh.float()  # [B, h, N, d]
    dk = torch.zeros((b, num_heads, m, d), dtype=torch.float32,
                     device=q.device).scatter_add_(2, idx, contrib)
    dk = dk.transpose(1, 2).reshape(b, m, c)
    return dq.to(q.dtype), dk.to(k.dtype)


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_cuda(q: torch.Tensor, k: torch.Tensor, num_heads: int) -> None:
    if q.device.type != "cuda" or k.device != q.device:
        raise ValueError(
            f"q and k must both be CUDA tensors of one device or both lie on "
            f"the CPU (or meta), got {q.device} and {k.device}"
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
    c, m = q.shape[2], k.shape[1]
    if c % num_heads or c // num_heads > 64 or m == 0:
        raise ValueError(
            f"the kernel takes head dims <= 64 and M > 0; got C={c}, "
            f"heads={num_heads}, M={m}"
        )


def _scores_cuda(q, k, num_heads, scale, argmax: bool):
    """The forward kernel: s [B, N], and amax [B, h, N] when ``argmax``."""
    b, n, c = q.shape
    m = k.shape[1]
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    lib, suffix = "maxpool_attention_scores", _SUFFIX[q.dtype]
    if argmax:
        amax = torch.empty((b, num_heads, n), dtype=torch.int32,
                           device=q.device)
        _build.launch(lib, f"maxpool_attention_scores_argmax_{suffix}",
                      q.device, q.data_ptr(), k.data_ptr(), out.data_ptr(),
                      amax.data_ptr(), b, n, m, c, num_heads, float(scale))
    else:
        amax = None
        _build.launch(lib, f"maxpool_attention_scores_{suffix}", q.device,
                      q.data_ptr(), k.data_ptr(), out.data_ptr(), b, n, m, c,
                      num_heads, float(scale))
    maxpool_attention_scores.launches += 1
    return out, amax


class BackwardPlan(NamedTuple):
    """The backward kernel's launch, as the wrapper passes it to
    ``csrc/maxpool_attention_scores_bwd.cu``, which takes every field as
    given."""

    tokens: int  # tokens per chunk of pass 1
    chunks: int
    slots: int  # partial rows a chunk may write: min(tokens, M)
    smem: int  # pass 1's dynamic shared memory per block, bytes


# csrc/maxpool_attention_scores_bwd.cu: threads (and most tokens) per block,
# warps per block, shared memory a block may use (H100)
_BWD_THREADS = 256
_BWD_WARPS = 8
_SMEM_MAX = 232448


@functools.lru_cache(maxsize=None)
def scores_backward_plan(b: int, n: int, m: int, c: int, heads: int,
                         itemsize: int, sms: int,
                         tokens: int = 0) -> BackwardPlan:
    """Pass 1's blocks of the backward kernel for q [b, n, c] and k [b, m,
    c] of ``itemsize``-byte elements with ``heads`` heads, on a card with
    ``sms`` SMs: ``tokens`` per chunk when given (at most 256), else the
    most of 256, 128, 64, 32 that still give a block per SM (b * heads *
    chunks of them; 32 where none does). Its shared memory holds, in this
    order, the chunk's q head slice (padded to 16 bytes), a segment (two
    ints) per slot, three ints or floats per token, two ints per key and
    two per warp; so many keys that they do not fit (some 20,000 or more,
    by the tokens, d and dtype) raise."""
    if heads <= 0 or c % heads:
        raise ValueError(f"C={c} is not a multiple of heads={heads}")
    d = c // heads
    if tokens <= 0:
        tokens = _BWD_THREADS
        while tokens > 32 and b * heads * -(-n // tokens) < sms:
            tokens //= 2
    elif tokens > _BWD_THREADS:
        raise ValueError(f"attention backward: {tokens} tokens per chunk, "
                         f"over {_BWD_THREADS}")
    slots = min(tokens, m)
    smem = (-(-tokens * d * itemsize // 16) * 16 + 8 * slots
            + 4 * (3 * tokens + 2 * m + 2 * _BWD_WARPS))
    if smem > _SMEM_MAX:
        raise ValueError(f"attention backward: M={m} keys need {smem} bytes "
                         f"of shared memory per block, over {_SMEM_MAX}")
    return BackwardPlan(tokens, -(-n // tokens), slots, smem)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _scores_backward_cuda(q, k, amax, g, num_heads, scale):
    b, n, c = q.shape
    index = q.device.index
    plan = scores_backward_plan(b, n, k.shape[1], c, num_heads,
                                q.element_size(),
                                _sm_count(torch.cuda.current_device()
                                          if index is None else index))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    launch_backward(q, k, amax, g.float().contiguous(), dq, dk, num_heads,
                    scale, plan)
    maxpool_attention_scores_backward.launches += 1
    return dq, dk


def launch_backward(q, k, amax, g, dq, dk, num_heads, scale,
                    plan: BackwardPlan) -> None:
    """Launch the backward kernel on contiguous CUDA q, k, amax and fp32 g
    into dq and dk with ``plan``, its partial rows and slot maps in
    scratch of their own."""
    b, n, c = q.shape
    m = k.shape[1]
    rows = b * num_heads * plan.chunks
    partial = torch.empty(rows * plan.slots * (c // num_heads),
                          dtype=torch.float32, device=q.device)
    slotmap = torch.empty(rows * m, dtype=torch.int32, device=q.device)
    _build.launch("maxpool_attention_scores_bwd",
                  f"maxpool_attention_scores_bwd_{_SUFFIX[q.dtype]}",
                  q.device, q.data_ptr(), k.data_ptr(), amax.data_ptr(),
                  g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  partial.data_ptr(), slotmap.data_ptr(), b, n, m, c,
                  num_heads, plan.tokens, plan.chunks, plan.slots, plan.smem,
                  float(scale))


def _scores_argmax_op_cuda(q, k, num_heads, scale):
    _check_cuda(q, k, num_heads)
    return _scores_cuda(q.contiguous(), k.contiguous(), num_heads, scale,
                        True)


def _scores_argmax_fake(q, k, num_heads, scale):
    b, n, _ = q.shape
    return (q.new_empty((b, n), dtype=torch.float32),
            q.new_empty((b, num_heads, n), dtype=torch.int32))


def _scores_backward_op_cuda(q, k, amax, g, num_heads, scale):
    _check_cuda(q, k, num_heads)
    return _scores_backward_cuda(q.contiguous(), k.contiguous(),
                                 amax.contiguous(), g, num_heads, scale)


# the training forward and the backward as operators of their own, as the
# no-grad forward (``scores_op``) below
scores_argmax_op = _build.register_op(
    "maxpool_attention_scores_argmax",
    "(Tensor q, Tensor k, int num_heads, float scale) -> (Tensor, Tensor)",
    cpu=maxpool_attention_scores_argmax_reference,
    cuda=_scores_argmax_op_cuda, fake=_scores_argmax_fake)
scores_backward_op = _build.register_op(
    "maxpool_attention_scores_bwd",
    "(Tensor q, Tensor k, Tensor amax, Tensor g, int num_heads, float scale)"
    " -> (Tensor, Tensor)",
    cpu=maxpool_attention_scores_backward_reference,
    cuda=_scores_backward_op_cuda,
    fake=lambda q, k, amax, g, num_heads, scale: (torch.empty_like(q),
                                                  torch.empty_like(k)))


def _per_sample_vmap(name):
    """The vmap rule of the operator at module attribute ``name``, whose
    tensors all lead with the batch dimension, each sample's keys its own:
    [T, B, ...] folds to [T*B, ...], one call (one launch) for every
    trial."""
    def rule(info, in_dims, *args):
        n = sum(1 for a in args if isinstance(a, torch.Tensor))
        tensors = _build.batch_first(info, in_dims[:n], *args[:n])
        out = globals()[name](*(_build.fold(t) for t in tensors), *args[n:])
        trials = info.batch_size
        if isinstance(out, tuple):
            return tuple(_build.unfold(o, trials) for o in out), (0,) * len(
                out)
        return _build.unfold(out, trials), 0
    return rule


_build.register_vmap("maxpool_attention_scores_argmax",
                     _per_sample_vmap("scores_argmax_op"))
_build.register_vmap("maxpool_attention_scores_bwd",
                     _per_sample_vmap("scores_backward_op"))


def maxpool_attention_scores_with_argmax(q, k, num_heads: int, scale: float):
    """(s [B, N] fp32, amax [B, h, N] int32): the kernel's ``_argmax``
    entry point on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type not in _build.NO_KERNEL or k.device != q.device:
        _check_cuda(q, k, num_heads)
    return scores_argmax_op(q, k, num_heads, float(scale))


def maxpool_attention_scores_backward(q, k, amax, g, num_heads: int,
                                      scale: float):
    """(dq, dk) of the scores for the cotangent ``g`` [B, N]: the backward
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type not in _build.NO_KERNEL:
        _check_cuda(q, k, num_heads)
    return scores_backward_op(q, k, amax, g, num_heads, float(scale))


maxpool_attention_scores_backward.launches = 0


class _Scores(torch.autograd.Function):
    """The scores with the JAX package's custom VJP: argmax saved in the
    forward, gather and scatter-add in the backward. Under
    ``torch.func.vmap`` both go through the operators' vmap rules."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, num_heads, scale):
        return maxpool_attention_scores_with_argmax(q, k, num_heads, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, num_heads, scale = inputs
        ctx.save_for_backward(q, k, output[1])
        ctx.mark_non_differentiable(output[1])
        ctx.num_heads, ctx.scale = num_heads, scale

    @staticmethod
    def backward(ctx, g, g_amax):
        q, k, amax = ctx.saved_tensors
        dq, dk = maxpool_attention_scores_backward(q, k, amax, g,
                                                   ctx.num_heads, ctx.scale)
        return dq, dk, None, None


def _scores_op_cuda(q, k, num_heads, scale):
    _check_cuda(q, k, num_heads)
    return _scores_cuda(q.contiguous(), k.contiguous(), num_heads, scale,
                        False)[0]


# the no-grad forward as an operator of its own: the plain version on the
# CPU, the kernel on a CUDA device (where it counts the launch)
scores_op = _build.register_op(
    "maxpool_attention_scores",
    "(Tensor q, Tensor k, int num_heads, float scale) -> Tensor",
    cpu=maxpool_attention_scores_reference, cuda=_scores_op_cuda,
    fake=lambda q, k, num_heads, scale: q.new_empty(q.shape[:2],
                                                    dtype=torch.float32))
_build.register_vmap("maxpool_attention_scores",
                     _per_sample_vmap("scores_op"))


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
      fp32 [B, N]; differentiable in q and k (through :class:`_Scores`;
      without gradients through ``scores_op``).
    """
    if _build.needs_grad(q, k):
        return _Scores.apply(q, k, num_heads, scale)[0]
    if q.device.type not in _build.NO_KERNEL or k.device != q.device:
        _check_cuda(q, k, num_heads)
    return scores_op(q, k, num_heads, float(scale))


maxpool_attention_scores.launches = 0


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

    Under a spatial shard (``parallel/spatial.py``) x and q are this rank's
    tokens and k holds all M keys: vbar is the whole image's token mean,
    the fp32 sum across the sp group over the whole token count.
    """
    s = maxpool_attention_scores(q, k, num_heads, scale)
    shard = spatial.active()
    if shard is None:
        vbar = x.float().mean(dim=1, keepdim=True)  # [B, 1, C]
    else:
        vbar = (spatial.sum_across(x.float().sum(dim=1, keepdim=True))
                / shard.global_count(x.shape[1]))
    return (s[:, :, None] * vbar).to(x.dtype)
