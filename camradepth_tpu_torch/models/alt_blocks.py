"""Alternative building blocks from the reference's component library.

Counterpart of ``camradepth_tpu/models/alt_blocks.py``: blocks that the
reference ships but the published model does not wire in (utils.py
``AttentionBlcok`` :12-28, ``SparaseDenseLayer``/``SparaseDenseBlock``
:30-84, ``ResBlock`` :137-199, ``Acti`` :259-272, ``Unpool``
loss_funcs.py:182-196, and ``Conv_Attention`` simplified_attention.py:
326-376), as NHWC ``nn.Module``s built from the port's layers. A module
takes its input channel count, which torch needs at construction; the
child names are the JAX package's (``layers_0`` is ``layers.0``,
``blocks_0`` is ``blocks.0``), a ConvLayer's conv and norm are
``model.0`` and ``model.1``, as everywhere in the port.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from camradepth_tpu_torch.models.encoder import Block, OverlapPatchEmbed
from camradepth_tpu_torch.models.layers import Conv2d, ConvLayer
from camradepth_tpu_torch.ops.resize import upsample_bicubic_x2


class ChannelAttention(nn.Module):
    """Global-average-pool channel attention vector (reference
    ``AttentionBlcok`` [sic]): GAP -> 1x1 ConvLayer x2 -> sigmoid (in
    fp32, rounded to the input dtype), [B, 1, 1, features]."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv1 = ConvLayer(in_ch, features, 1, 1, 0)
        self.conv2 = ConvLayer(features, features, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = x.mean(dim=(1, 2), keepdim=True)
        v = self.conv2(self.conv1(v))
        return torch.sigmoid(v.float()).to(x.dtype)


class SparseDenseLayer(nn.Module):
    """A conv branch modulated by its channel attention (reference
    ``SparaseDenseLayer`` [sic]): out = conv3x3(x) * atten(x) +
    conv3x3(x), then a combine conv (a plain conv in a final block)."""

    def __init__(self, in_ch: int, features: int, mid_channels: int = 128,
                 as_final_block: bool = False):
        super().__init__()
        self.conv3x3 = ConvLayer(in_ch, mid_channels)
        self.atten = ChannelAttention(in_ch, mid_channels)
        self.conv_combine = (Conv2d(mid_channels, features, 3, 1, 1)
                             if as_final_block
                             else ConvLayer(mid_channels, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv3x3(x)
        out = out * self.atten(x) + out
        return self.conv_combine(out)


class SparseDenseBlock(nn.Module):
    """A dense stack of :class:`SparseDenseLayer` (utils.py:55-84)."""

    def __init__(self, in_ch: int, features: int, mid_channels: int = 128,
                 num_layers: int = 1, as_final_block: bool = False):
        super().__init__()
        layers = []
        ch = in_ch
        for i in range(num_layers):
            last = i == num_layers - 1
            layers.append(SparseDenseLayer(
                ch, features if last else mid_channels, mid_channels,
                as_final_block=as_final_block and last))
            ch += mid_channels
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.cat([x, layer(x)], dim=-1)
        return self.layers[-1](x)


class ResBlock(nn.Module):
    """The full dense/residual block (utils.py:137-199). dense: 1x1, 3x3,
    1x1 densely concatenated; else a residual 1-3-1 bottleneck with a
    concat tail; then the tail conv (a ConvLayer and a plain conv in a
    final block)."""

    def __init__(self, in_ch: int, features: int, mid_channels: int = 128,
                 dense: bool = False, as_final_block: bool = False):
        super().__init__()
        mid = mid_channels
        self.dense = dense
        self.block_1 = ConvLayer(in_ch, mid, 1, 1, 0)
        self.block_2 = ConvLayer(in_ch + mid if dense else mid, mid, 3, 1, 1)
        self.block_3 = ConvLayer(in_ch + 2 * mid if dense else mid, mid, 1,
                                 1, 0)
        tail_in = in_ch + 3 * mid if dense else in_ch + mid
        self.as_final_block = as_final_block
        if as_final_block:
            self.block_4_0 = ConvLayer(tail_in, mid, 3, 1, 1)
            self.block_4_1 = Conv2d(mid, features, 3, 1, 1)
        else:
            self.block_4 = ConvLayer(tail_in, features, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dense:
            x = torch.cat([x, self.block_1(x)], -1)
            x = torch.cat([x, self.block_2(x)], -1)
            x = torch.cat([x, self.block_3(x)], -1)
        else:
            out1 = self.block_1(x)
            inter = out1 + self.block_2(out1)
            inter = inter + self.block_3(inter)
            x = torch.cat([x, inter], -1)
        if self.as_final_block:
            return self.block_4_1(self.block_4_0(x))
        return self.block_4(x)


class Acti(nn.Module):
    """sigmoid -> 3x3 conv head (utils.py:259-272)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv_2 = Conv2d(in_ch, features, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_2(torch.sigmoid(x))


def unpool_x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 zero-stuffing unpool of NHWC ``x`` (reference Unpool: a
    conv_transpose with a [1,0;0,0] kernel)."""
    b, h, w, c = x.shape
    out = x.new_zeros((b, h, 2, w, 2, c))
    out[:, :, 0, :, 0, :] = x
    return out.reshape(b, 2 * h, 2 * w, c)


class ConvAttention(nn.Module):
    """Patch embed + transformer blocks + bicubic x2 + a 1x1 fuse ConvLayer
    over the concat with the input (reference Conv_Attention; unused by the
    published model)."""

    def __init__(self, in_ch: int, features: int, embed_dim: int = 128,
                 num_heads: int = 4, num_blocks: int = 4, patch_size: int = 3,
                 stride: int = 2, divisor: int = 16):
        super().__init__()
        self.patch_embed1 = OverlapPatchEmbed(in_ch, embed_dim, patch_size,
                                              stride, divisor)
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, 1, 8, qkv_bias=True, divisor=divisor)
            for _ in range(num_blocks)])
        self.final_conv = ConvLayer(embed_dim + in_ch, features, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.patch_embed1(x)
        b, h, w, c = y.shape
        tok = y.reshape(b, h * w, c)
        for blk in self.blocks:
            tok = blk(tok, (h, w))
        y = upsample_bicubic_x2(tok.reshape(b, h, w, c))
        return self.final_conv(torch.cat([y, x.to(y.dtype)], dim=-1))
