"""Convolutional building blocks on logical-NHWC tensors.

Counterparts of ``camradepth_tpu/models/layers.py``: ``ConvLayer``
(reference utils.py:201-228), ``ShortResBlock`` (:103-135), ``Decoder``
(:231-257) and ``DepthActivation`` (:274-289). Tensors are NHWC as in the
JAX package. A convolution is handed the ``permute(0, 3, 1, 2)`` view of its
input, which is NCHW in ``channels_last`` memory, so cuDNN runs NHWC with no
copy, and its output is permuted back.

Parameter names and shapes are the reference ``state_dict`` layout, so a
reference checkpoint loads with ``load_state_dict(strict=True)``.

Under a spatial shard (``parallel/spatial.py``) a tensor holds this rank's
rows. A convolution taller than one row takes its neighbours' halo rows
and pads zeros in H only at the image's own edges; the decoder's bicubic
x2 runs on the rank's rows plus 2 halo rows each side and drops the output
rows of each cut side's halo, so the kernel's edge replication acts only
at the image's edges. Everything else is row-local.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from camradepth_tpu_torch.ops.gelu import gelu_for_dtype
from camradepth_tpu_torch.ops.groupnorm import group_norm
from camradepth_tpu_torch.ops.resize import upsample_bicubic_x2
from camradepth_tpu_torch.parallel import spatial


def cast_to(p: Optional[torch.Tensor], dtype: torch.dtype):
    """A parameter in the compute dtype: itself when it is held in that
    dtype (inference), else cast at use, as flax casts fp32 params with
    ``dtype=bfloat16`` (training keeps fp32 master weights)."""
    return p if p is None or p.dtype == dtype else p.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (weight [O, I, kh, kw]) applied to NHWC tensors, with
    the weight and bias cast to the input's dtype at use. The bias is added
    after the convolution's output is rounded to that dtype, as flax's
    ``Conv(dtype=bfloat16)`` adds it (a bias fused into the convolution
    would be added before the one rounding).

    A bf16 convolution on the CPU runs in fp32 and rounds its output to
    bf16, as cuDNN and XLA do: oneDNN's bf16 path loses precision on the
    strided 8x8 sr-conv (errors of several units on outputs of order 1)."""

    def _rows(self, x: torch.Tensor):
        """``x`` with the rows this rank's output rows read (under a
        spatial shard: the halo of a kernel taller than one row, zeros past
        the image's edges) and the H padding left to the convolution."""
        if spatial.active() is None:
            return x, self.padding
        kh, sh, ph = self.kernel_size[0], self.stride[0], self.padding[0]
        top, bottom = ph, kh - ph - sh
        if bottom < 0 or x.shape[1] % sh:
            raise ValueError(f"a {kh}-row kernel of stride {sh} and padding "
                             f"{ph} cannot run on {x.shape[1]} sharded rows")
        x, n_top, n_bottom = spatial.halo(x, top, bottom)
        if n_top < top or n_bottom < bottom:
            x = F.pad(x, (0, 0, 0, 0, top - n_top, bottom - n_bottom))
        return x, (0, self.padding[1])

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution without its bias, in the dtype of ``x``."""
        x, padding = self._rows(x)
        xc = x.permute(0, 3, 1, 2)
        weight = cast_to(self.weight, x.dtype)
        if x.device.type == "cpu" and x.dtype == torch.bfloat16:
            y = self._conv(xc.float(), weight.float(), padding).to(x.dtype)
        else:
            y = self._conv(xc, weight, padding)
        return y.permute(0, 2, 3, 1)

    def _conv(self, xc, weight, padding):
        if padding == self.padding:
            return self._conv_forward(xc, weight, None)
        return F.conv2d(xc, weight, None, self.stride, padding,
                        self.dilation, self.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.product(x)
        return y if self.bias is None else y + cast_to(self.bias, x.dtype)


class TokenLinear(nn.Conv1d):
    """A 1x1 ``nn.Conv1d`` over tokens (weight [O, I, 1], the reference
    layout) applied to [B, N, C] tokens as a dense projection; the bias is
    added after the product is rounded, as flax's ``Dense`` adds it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__(in_features, out_features, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, cast_to(self.weight, x.dtype)[:, :, 0])
        return y if self.bias is None else y + cast_to(self.bias, x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm with fp32 statistics and fp32 affine (weight/bias, torch
    names) over the last axis, eps 1e-5. ``num_groups`` is explicit so the
    MixFFN norm2 quirk can be kept (``encoder.py:82-89``)."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups)


def group_norm_divisor(channels: int, divisor: int = 16) -> GroupNorm:
    """GroupNorm with C // divisor groups, as the reference everywhere
    (args.py:37)."""
    return GroupNorm(max(1, channels // divisor), channels)


def _draw_keep(x: torch.Tensor, shape, keep: float, generator,
               shard) -> torch.Tensor:
    """The keep mask of ``shape`` (rows first) for ``x``. Under a batch
    shard (``shard.index`` of ``shard.count`` ranks, see
    ``parallel/multihost.BatchShard``) the mask is drawn for the global
    batch and this rank's rows are taken, so the ranks' masks are the
    single-process draw's, as JAX's SPMD draw is a function of the global
    shape."""
    if shard is None or shard.count == 1:
        return torch.rand(shape, generator=generator, device=x.device) < keep
    b = shape[0]
    full = torch.rand((b * shard.count,) + tuple(shape[1:]),
                      generator=generator, device=x.device)
    return full[shard.index * b:(shard.index + 1) * b] < keep


class DropPath(nn.Module):
    """Per-sample stochastic depth; identity at eval or at rate 0. The mask
    is drawn from ``generator`` (the run's explicit generator, set by
    ``CamRaDepth.set_generator``) when one is set, for this rank's rows of
    the global batch under a batch ``shard``."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.shard = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = _draw_keep(x, shape, keep, self.generator, self.shard)
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout2d(nn.Module):
    """Channel dropout over NHWC (torch Dropout2d, CamRaDepth.py:96): whole
    feature maps are dropped, broadcast over H and W. Identity at eval.
    Drawn as :class:`DropPath` draws."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.shard = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0], 1, 1, x.shape[-1])
        mask = _draw_keep(x, shape, keep, self.generator, self.shard)
        return torch.where(mask, x / keep, torch.zeros_like(x))


def remat(module: nn.Module, *args):
    """``module(*args)``, its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, the counterpart of ``nn.remat``).

    The recompute replays the global RNG state (for masks drawn without a
    generator), not a ``torch.Generator`` object, so a dropout mask drawn
    from the run's generator would be drawn anew. The generators of the
    module's dropout layers are therefore rewound to their state at the
    forward for the recompute, and put back after it.

    The recompute runs in the backward pass, on the card in the autograd
    engine's own thread, where the forward's spatial shard
    (``parallel/spatial.sharded``) is not set: it runs under the shard
    captured at the forward, and in full (no early stop), so that every
    rank of the sp group makes the same collectives in it."""
    gens = {id(m.generator): m.generator for m in module.modules()
            if isinstance(m, (DropPath, Dropout2d))
            and m.generator is not None}
    saved = [(g, g.get_state()) for g in gens.values()]
    shard = spatial.active()
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return module(*a)
        now = [(g, g.get_state()) for g, _ in saved]
        for g, state in saved:
            g.set_state(state)
        try:
            with spatial.sharded(shard):
                return module(*a)
        finally:
            for g, state in now:
                g.set_state(state)

    with set_checkpoint_early_stop(shard is None):
        return checkpoint(run, *args, use_reentrant=False)


class ConvLayer(nn.Module):
    """conv(bias=False) -> GroupNorm -> GELU (utils.py:201-228); the
    reference keys are ``model.0`` (conv) and ``model.1`` (norm)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1):
        super().__init__()
        self.model = nn.ModuleList([
            Conv2d(in_ch, out_ch, kernel_size, stride, padding, bias=False),
            group_norm_divisor(out_ch),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu_for_dtype(self.model[1](self.model[0](x)))


class ShortResBlock(nn.Module):
    """3-layer shrinking dense block (utils.py:103-135). Channel plan for
    mid=128: in -> 96, cat -> 64, cat -> out."""

    def __init__(self, in_ch: int, features: int, mid_channels: int = 128,
                 num_layers: int = 3):
        super().__init__()
        widths = [int(mid_channels * (0.75 - 0.25 * i))
                  for i in range(num_layers - 1)] + [features]
        layers = []
        ch = in_ch
        for width in widths:
            layers.append(ConvLayer(ch, width))
            ch += width
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.cat([x, layer(x)], dim=-1)
        return self.layers[-1](x)


def upsample_rows_x2(x: torch.Tensor) -> torch.Tensor:
    """:func:`upsample_bicubic_x2` of this rank's rows: under a spatial
    shard the rows go in with up to 2 halo rows each side (each output row
    reads 2 input rows beyond its own), and the 2 output rows of each
    attached halo row are dropped. Where fewer are attached, the tensor
    ends at the image's edge, whose replication the kernel does itself."""
    xh, n_top, n_bottom = spatial.halo(x, 2, 2)
    y = upsample_bicubic_x2(xh)
    if n_top or n_bottom:
        y = y[:, 2 * n_top:2 * (n_top + x.shape[1])]
    return y


class Decoder(nn.Module):
    """Bicubic x2 upsample -> optional skip concat -> ShortResBlock
    (utils.py:231-257). The upsample is the port's kernel wrapper."""

    def __init__(self, in_ch: int, features: int, skip_ch: int = 0,
                 mid_channels: int = 128):
        super().__init__()
        self.has_skip = skip_ch > 0
        self.conv = ShortResBlock(in_ch + skip_ch, features, mid_channels)

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = upsample_rows_x2(x)
        if self.has_skip:
            if skip is None:
                raise ValueError("this decoder stage needs a skip input")
            x = torch.cat([x, skip.to(x.dtype)], dim=-1)
        return self.conv(x)


class _SigmoidBf16(torch.autograd.Function):
    """``jax.nn.sigmoid`` on bf16 as XLA compiles it: 1 / (1 + exp(-x)),
    each operation rounded to bf16, and its VJP g * (y * (1 - y)), each
    operation rounded (XLA:CPU's optimized HLO of the bf16 train step;
    torch's ``sigmoid`` and its backward round once)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.reciprocal(1.0 + torch.exp(-x))  # 1.0 / t is two ops

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1.0 - y))


def sigmoid_for_dtype(x: torch.Tensor) -> torch.Tensor:
    """The depth heads' sigmoid, rounded as XLA rounds it in bf16."""
    if x.dtype == torch.bfloat16:
        return _SigmoidBf16.apply(x)
    return torch.sigmoid(x)


class DepthActivation(nn.Module):
    """conv -> sigmoid -> conv depth head (utils.py:274-289), rounded in
    bf16 as XLA compiles the JAX package's head, which departs from its
    source in two places: the sigmoid is four rounded operations
    (:func:`sigmoid_for_dtype`), and the head returns fp32, conv_2's
    product rounded to the compute dtype plus its bias, not rounded again.
    The JAX model casts each head's output to fp32 right after its bias
    add (``camradepth_tpu/models/camradepth.py:246``), and XLA drops that
    add's bf16 rounding: its optimized HLO of the bf16 train step adds the
    bias in fp32 and feeds the sum to the loss as it is. The caller rounds
    the depth where it joins the bf16 features."""

    def __init__(self, in_ch: int, features: int = 1, iter_channels: int = 32):
        super().__init__()
        self.conv_1 = Conv2d(in_ch, iter_channels, 3, padding=1)
        self.conv_2 = Conv2d(iter_channels, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_2.product(sigmoid_for_dtype(self.conv_1(x)))
        return y.float() + cast_to(self.conv_2.bias, x.dtype).float()


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, H/r, W/r, r*r*C], the channel blocks
    ordered (row, col, C) as ``camradepth_tpu/models/layers.py:218-224``
    orders them (``torch.pixel_unshuffle`` orders them (C, row, col))."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // r, w // r, r * r * c)


def depth_to_space(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NHWC [B, H, W, r*r*C] -> [B, r*H, r*W, C], the inverse of
    :func:`space_to_depth` (``layers.py:227-233``)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * r, w * r, c // (r * r))


class TPUDecoder(nn.Module):
    """The decoder stage of the ``tpu_decoder`` variant (``layers.py:
    236-274``): three 128-wide ConvLayers, densely concatenated, at the
    input's resolution; a skip at twice that resolution is folded in by
    :func:`space_to_depth`, and with ``upsample_out`` the last layer emits
    ``4 * features`` channels that :func:`depth_to_space` turns into the x2
    upsample. No bicubic. Children are ``conv_0`` .. ``conv_2``."""

    def __init__(self, in_ch: int, features: int, skip_ch: int = 0,
                 upsample_out: bool = True, width: int = 128):
        super().__init__()
        self.has_skip = skip_ch > 0
        self.upsample_out = upsample_out
        ch = in_ch + 4 * skip_ch
        self.conv_0 = ConvLayer(ch, width)
        self.conv_1 = ConvLayer(ch + width, width)
        self.conv_2 = ConvLayer(ch + 2 * width,
                                4 * features if upsample_out else features)

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.has_skip:
            if skip is None:
                raise ValueError("this decoder stage needs a skip input")
            x = torch.cat([x, space_to_depth(skip.to(x.dtype))], dim=-1)
        x = torch.cat([x, self.conv_0(x)], dim=-1)
        x = torch.cat([x, self.conv_1(x)], dim=-1)
        y = self.conv_2(x)
        return depth_to_space(y) if self.upsample_out else y


class SubpixelDepthActivation(nn.Module):
    """The final depth head of the ``tpu_decoder`` variant (``layers.py:
    277-315``): conv (128 wide) -> sigmoid -> conv to 4 channels at half
    resolution, then :func:`depth_to_space`. It rounds as
    :class:`DepthActivation` but for the last add: the depth-to-space lies
    between that add and the model's cast to fp32, and XLA keeps the add's
    bf16 rounding there (the JAX bf16 forward's final depth is all bf16
    values), so the head returns conv_2's output in the compute dtype."""

    def __init__(self, in_ch: int, features: int = 1,
                 iter_channels: int = 128):
        super().__init__()
        self.conv_1 = Conv2d(in_ch, iter_channels, 3, padding=1)
        self.conv_2 = Conv2d(iter_channels, 4 * features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return depth_to_space(self.conv_2(sigmoid_for_dtype(self.conv_1(x))))


class SegConv(Conv2d):
    """A seg logits head: one 3x3 conv with bias and torch's default init
    (``layers.py:328-348``; the reference keys are the bare conv's). Like
    the depth heads it returns fp32: the product rounded to the compute
    dtype plus the bias, the add not rounded again, as XLA compiles the
    head where the model casts its output to fp32 right after it. Where
    the logits go on in the compute dtype (the argmax, the depth-to-space
    of the ``tpu_decoder`` variant), the caller rounds them."""

    def __init__(self, in_ch: int, features: int):
        super().__init__(in_ch, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.product(x).float() + cast_to(self.bias, x.dtype).float()


def seg_block(seg_logits: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The guidance map of seg logits (``layers.py:318-325``): the argmax
    over the class axis (the first index on ties), as fp32 divided by
    ``num_classes``, in the logits' dtype, [B, H, W, 1]. No gradient flows
    through it, as through the argmax of the JAX package."""
    idx = torch.argmax(seg_logits, dim=-1, keepdim=True)
    return (idx.float() / num_classes).to(seg_logits.dtype)
