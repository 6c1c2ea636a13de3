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
Both go through the operator ``torch.ops.camradepth.upsample_bicubic_x2``
(``upsample_op``; its CUDA implementation launches and counts), which
an exported graph (``interop/export.py``) keeps.
:func:`upsample_plan` sizes the kernel's blocks. When gradients must flow,
the call goes through :class:`_Upsample`, whose backward is the adjoint of
the edge pad and two-phase filter, rounded where XLA rounds the transpose
the JAX package takes (``camradepth_tpu/ops/resize.py:84-105``,
``resize_pallas.py:250-255``): each axis back over its padded length in
fp32, rounded to the input dtype, then the pads folded into the edge rows
by rounded adds, the W axis first, then H; on the card
``csrc/upsample_bicubic_x2_bwd.cu`` (one launch for both axes, blocks sized
by :func:`upsample_backward_plan`), on the CPU
:func:`upsample_bicubic_x2_backward_reference`, bit for bit alike, through
the operator ``torch.ops.camradepth.upsample_bicubic_x2_bwd``
(``upsample_bwd_op``). Both operators have ``torch.func.vmap`` rules that
fold the vmapped dimension into the batch of images (one launch for every
trial), from which :class:`_Upsample` takes its own.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

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


# The transpose's taps: padded input j receives the outputs o = 2j - 7 + s
# (s = 0..7) with these weights, the phases' weights interleaved.
ADJOINT_TAPS = (W_EVEN[0], W_EVEN[3], W_EVEN[1], W_EVEN[2],
                W_EVEN[2], W_EVEN[1], W_EVEN[3], W_EVEN[0])


def _adjoint_axis_x2(g: torch.Tensor, axis: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """Transpose of :func:`_upsample_axis_x2` along ``axis`` of an fp32
    NHWC tensor (2n -> n), in the values of ``dtype`` (held in fp32), as
    XLA transposes the JAX package's edge pad and filter:

    - the cotangent of the edge-padded input (n + 4 rows): padded row j
      sums ``ADJOINT_TAPS[s] * g[2j - 7 + s]`` over s in order (0 outside
      [0, 2n)), each product and sum rounded in fp32, then rounds to dtype;
    - the pads fold back into the edge rows, each add rounded to dtype:
      the last two padded rows are added together and into row n - 1,
      then the first two together and into row 0 (for n = 1 both land on
      row 0, in that order)."""
    n = g.shape[axis] // 2
    pad = list(g.shape)
    pad[axis] = 7
    gp = torch.cat([g.new_zeros(pad), g, g.new_zeros(pad)], dim=axis)
    acc = None
    for s, tap in enumerate(ADJOINT_TAPS):
        index = [slice(None)] * g.ndim
        index[axis] = slice(s, s + 2 * (n + 4), 2)
        term = gp[tuple(index)] * tap
        acc = term if acc is None else acc + term

    def rnd(t):
        return t.to(dtype).float()

    p = rnd(acc)
    rows = p.narrow(axis, 2, n)
    tail = rnd(p.narrow(axis, n + 2, 1) + p.narrow(axis, n + 3, 1))
    last = rnd(rows.narrow(axis, n - 1, 1) + tail)
    rows = torch.cat([rows.narrow(axis, 0, n - 1), last], dim=axis)
    head = rnd(p.narrow(axis, 0, 1) + p.narrow(axis, 1, 1))
    first = rnd(rows.narrow(axis, 0, 1) + head)
    return torch.cat([first, rows.narrow(axis, 1, n - 1)], dim=axis)


def upsample_bicubic_x2_backward_reference(gy: torch.Tensor) -> torch.Tensor:
    """Plain version of the adjoint: [B, 2H, 2W, C] -> [B, H, W, C] in the
    dtype of ``gy``; the W axis first, then H, each rounded to that dtype
    where XLA rounds it."""
    gw = _adjoint_axis_x2(gy.float(), 2, gy.dtype)
    return _adjoint_axis_x2(gw, 1, gy.dtype).to(gy.dtype)


# csrc/upsample_bicubic_x2.cu: threads per block, 16-byte vectors per
# thread in its register window, shared memory a block may use (H100)
_THREADS = 256
_WINDOW = 2
SMEM_MAX = 232448


class UpsamplePlan(NamedTuple):
    tw: int  # input columns per block
    rows: int  # input rows per block
    grid: Tuple[int, int, int]  # (W spans, row strips, B)
    smem: int  # dynamic shared memory per block, bytes


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@functools.lru_cache(maxsize=None)
def upsample_plan(b: int, h: int, w: int, c: int, itemsize: int,
                  sms: int) -> UpsamplePlan:
    """Blocks of the kernel for [b, h, w, c] of ``itemsize``-byte elements
    on a card with ``sms`` SMs. A block's W span is the widest whose H rows
    (its columns, 2 more on each side, and the 16-byte alignment slack)
    fit in its threads' register windows, then evened out over the row;
    its strip of rows is the tallest of 16, 8, 4, 2, 1 that still gives 8
    blocks per SM (3 fit at once). The shared memory holds the two H-filtered rows (as
    float pairs) and the two staged output rows, as the kernel lays them out; a C so wide that
    one column with its halo does not fit (over 4,148 channels in fp32,
    4,838 in bf16) raises."""
    if min(h, w, c) <= 0:
        raise ValueError(f"upsample_bicubic_x2: empty image {(b, h, w, c)}")
    n = 16 // itemsize  # elements per 16-byte vector
    reach = _WINDOW * _THREADS * n
    tw = min(w, max(1, (reach - 2 * n) // c - 4))
    tw = -(-w // -(-w // tw))
    spans = -(-w // tw)
    rows = 16
    while rows > 1 and b * spans * -(-h // rows) < 8 * sms:
        rows //= 2
    cap = _round_up(min(tw + 4, w) * c + 2 * n, n)
    scap = _round_up(2 * tw * c + 2 * n, n)
    smem = 8 * cap + 2 * scap * itemsize  # float pairs; staged rows in T
    if smem > SMEM_MAX:
        raise ValueError(f"upsample_bicubic_x2: C={c} needs {smem} bytes of "
                         f"shared memory per block, over {SMEM_MAX}")
    return UpsamplePlan(tw, rows, (spans, -(-h // rows), b), smem)


class AdjointPlan(NamedTuple):
    """The adjoint kernel's launch, as the wrapper passes it to
    ``csrc/upsample_bicubic_x2_bwd.cu``, which takes every field as given."""

    threads: int  # per block: a thread per channel of its tile
    tiles: int  # channel tiles of ``threads`` channels
    rows: int  # gx rows per block
    grid: Tuple[int, int, int]  # (runs of 4 columns x tiles, strips, B)
    rowcap: int  # elements staged per gy row
    ocap: int  # elements staged per gx row
    smem: int  # dynamic shared memory per block, bytes


# csrc/upsample_bicubic_x2_bwd.cu: channels per block, gx columns per block,
# gy row pairs staged at once
_ADJOINT_TILE = 256
_ADJOINT_RUN = 4
_ADJOINT_STAGES = 4


@functools.lru_cache(maxsize=None)
def upsample_backward_plan(b: int, h: int, w: int, c: int, itemsize: int,
                           sms: int, rows: int = 0) -> AdjointPlan:
    """The adjoint kernel's launch for gx [b, h, w, c] of ``itemsize``-byte
    elements on a card with ``sms`` SMs. A block takes a run of 4 gx
    columns at up to 256 channels, a thread a channel; its strip of gx rows
    is ``rows`` when given, else the tallest of 32, 16, 8, 4 that still
    gives four blocks per SM (4 where none does). Its shared memory holds,
    in this order, four pairs of staged gy rows (the run's 14 gy columns,
    every channel, clipped to the row, and 16 bytes of slack at each end),
    two staged gx rows (the run's columns and the 16-byte slack before
    them) and three rows of edge-fold operands (4 columns x ``threads``); a
    C so wide that they do not fit (for w >= 7: over 941 channels in bf16,
    458 in fp32) raises."""
    if min(h, w, c) <= 0:
        raise ValueError(f"upsample_bicubic_x2 backward: empty image "
                         f"{(b, h, w, c)}")
    n = 16 // itemsize
    threads = _round_up(min(c, _ADJOINT_TILE), 32)
    tiles = -(-c // threads)
    rowcap = _round_up(min(2 * _ADJOINT_RUN + 6, 2 * w) * c + 2 * n, n)
    ocap = _round_up(_ADJOINT_RUN * c + n, n)
    smem = (2 * _ADJOINT_STAGES * rowcap + 2 * ocap
            + 3 * _ADJOINT_RUN * threads) * itemsize
    if smem > SMEM_MAX:
        raise ValueError(f"upsample_bicubic_x2 backward: C={c} needs {smem} "
                         f"bytes of shared memory per block, over {SMEM_MAX}")
    runs = -(-w // _ADJOINT_RUN) * tiles
    if rows <= 0:
        rows = 32
        while rows > 4 and b * runs * -(-h // rows) < 4 * sms:
            rows //= 2
    return AdjointPlan(threads, tiles, rows, (runs, -(-h // rows), b),
                       rowcap, ocap, smem)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"x must lie on a CUDA device or the CPU, got "
                         f"{x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"dtype must be one of {list(_SUFFIX)}, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"need NHWC [B,H,W,C], got {tuple(x.shape)}")


def _upsample_op_cuda(x):
    _check_cuda(x)
    b, h, w, c = x.shape
    x = x.contiguous()
    y = torch.empty((b, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    index = x.device.index
    plan = upsample_plan(b, h, w, c, x.element_size(), _sm_count(
        torch.cuda.current_device() if index is None else index))
    _build.launch("upsample_bicubic_x2",
                  f"upsample_bicubic_x2_{_SUFFIX[x.dtype]}", x.device,
                  x.data_ptr(), y.data_ptr(), b, h, w, c, plan.tw, plan.rows)
    upsample_bicubic_x2.launches += 1
    return y


def _upsample_op_fake(x):
    b, h, w, c = x.shape
    return x.new_empty((b, 2 * h, 2 * w, c))


# the forward outside autograd as an operator of its own: the plain
# version on the CPU, the kernel on a CUDA device (where it counts the
# launch)
upsample_op = _build.register_op(
    "upsample_bicubic_x2", "(Tensor x) -> Tensor",
    cpu=upsample_bicubic_x2_reference, cuda=_upsample_op_cuda,
    fake=_upsample_op_fake)


def _per_image_vmap(op):
    """The vmap rule of an operator that works image by image: the trial
    dimension folds into the batch dimension."""
    def rule(info, in_dims, x):
        (x,) = _build.batch_first(info, in_dims, x)
        return _build.unfold(op(_build.fold(x)), x.shape[0]), 0
    return rule


_build.register_vmap("upsample_bicubic_x2", _per_image_vmap(upsample_op))


def _forward(x: torch.Tensor) -> torch.Tensor:
    """The forward on either device, outside autograd."""
    if x.device.type not in _build.NO_KERNEL:
        _check_cuda(x)
    return upsample_op(x)


def _adjoint_shape(gy: torch.Tensor):
    b, h2, w2, c = gy.shape
    if h2 % 2 or w2 % 2:
        raise ValueError(f"gy must be [B, 2H, 2W, C], got {tuple(gy.shape)}")
    return b, h2 // 2, w2 // 2, c


def _upsample_bwd_op_cuda(gy):
    _check_cuda(gy)
    b, h, w, c = _adjoint_shape(gy)
    gy = gy.contiguous()
    gx = torch.empty((b, h, w, c), dtype=gy.dtype, device=gy.device)
    index = gy.device.index
    plan = upsample_backward_plan(b, h, w, c, gy.element_size(), _sm_count(
        torch.cuda.current_device() if index is None else index))
    launch_backward(gy, gx, plan)
    upsample_bicubic_x2_backward.launches += 1
    return gx


def _upsample_bwd_fake(gy):
    return gy.new_empty(_adjoint_shape(gy))


# the adjoint as an operator of its own, as the forward
upsample_bwd_op = _build.register_op(
    "upsample_bicubic_x2_bwd", "(Tensor gy) -> Tensor",
    cpu=upsample_bicubic_x2_backward_reference, cuda=_upsample_bwd_op_cuda,
    fake=_upsample_bwd_fake)
_build.register_vmap("upsample_bicubic_x2_bwd",
                     _per_image_vmap(upsample_bwd_op))


def upsample_bicubic_x2_backward(gy: torch.Tensor) -> torch.Tensor:
    """The adjoint of the upsample for the cotangent ``gy`` [B, 2H, 2W, C]:
    the backward kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if gy.device.type not in _build.NO_KERNEL:
        _check_cuda(gy)
    return upsample_bwd_op(gy)


def launch_backward(gy: torch.Tensor, gx: torch.Tensor,
                    plan: AdjointPlan) -> None:
    """Launch the adjoint kernel on contiguous CUDA ``gy`` into ``gx`` with
    ``plan``."""
    b, h, w, c = gx.shape
    _build.launch("upsample_bicubic_x2_bwd",
                  f"upsample_bicubic_x2_bwd_{_SUFFIX[gy.dtype]}", gy.device,
                  gy.data_ptr(), gx.data_ptr(), b, h, w, c, plan.threads,
                  plan.tiles, plan.rows, *plan.grid[:2], plan.rowcap,
                  plan.ocap, plan.smem)


upsample_bicubic_x2_backward.launches = 0


class _Upsample(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _forward(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, gy):
        return upsample_bicubic_x2_backward(gy)


def upsample_bicubic_x2(x: torch.Tensor) -> torch.Tensor:
    """Bicubic x2 over the spatial axes of NHWC ``x`` [B, H, W, C] (bf16 or
    fp32, any C); returns [B, 2H, 2W, C] in ``x.dtype``, differentiable."""
    if _build.needs_grad(x):
        return _Upsample.apply(x)
    return _forward(x)


upsample_bicubic_x2.launches = 0
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
