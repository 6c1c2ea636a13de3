"""Hierarchical softmax-free transformer encoder ("Simplified/DEST").

Counterpart of ``camradepth_tpu/models/encoder.py``: four stages of
OverlapPatchEmbed (stride 4, 2, 2, 2) and Blocks with max-pool attention
and a depthwise-conv MLP. Tokens are [B, N, C] and feature maps NHWC, so a
stage's tokens are a free reshape of its feature map. Under a spatial
shard (``parallel/spatial.py``) a stage's tokens are this rank's rows of
its feature map, and ``hw`` their local height and width.

Reference symbol map (simplified_attention.py):
  Mlp                   -> MixFFN                (:11-43)
  Attention_MaxPool     -> MaxPoolAttention      (:46-109)
  Block                 -> Block                 (:111-145)
  OverlapPatchEmbed     -> OverlapPatchEmbed     (:148-188)
  SimplifiedTransformer -> SimplifiedTransformer (:190-310)
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from camradepth_tpu_torch.models.layers import (
    Conv2d,
    DropPath,
    GroupNorm,
    TokenLinear,
    gelu_for_dtype,
    group_norm_divisor,
    remat,
)
from camradepth_tpu_torch.ops.attention import maxpool_attention
from camradepth_tpu_torch.parallel.spatial import all_gather_rows, sharded


class DWConv(nn.Module):
    """Depthwise 3x3 over the token grid; the reference nests the conv as
    ``dwconv.dwconv`` (simplified_attention.py:313-323)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        b, n, c = x.shape
        return self.dwconv(x.reshape(b, hw[0], hw[1], c)).reshape(b, n, c)


class MixFFN(nn.Module):
    """fc1 -> GN -> DWConv3x3 -> GN -> GELU -> fc2 (ref Mlp, :11-43)."""

    def __init__(self, dim: int, hidden: int, out_features: int,
                 divisor: int = 16):
        super().__init__()
        self.fc1 = TokenLinear(dim, hidden)
        self.norm1 = group_norm_divisor(hidden, divisor)
        self.dwconv = DWConv(hidden)
        # The reference's norm2 is GroupNorm(out_features // divisor, hidden):
        # the group count follows the OUT features while the normalized
        # tensor has `hidden` channels (simplified_attention.py:24).
        self.norm2 = GroupNorm(max(1, out_features // divisor), hidden)
        self.fc2 = TokenLinear(hidden, out_features)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        x = self.norm1(self.fc1(x))
        x = self.norm2(self.dwconv(x, hw))
        return self.fc2(gelu_for_dtype(x))


class MaxPoolAttention(nn.Module):
    """Softmax-free max-pool attention (ref Attention_MaxPool, :46-109)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 qkv_bias: bool = True, divisor: int = 16):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.sr_ratio = sr_ratio
        self.q = TokenLinear(dim, dim, bias=qkv_bias)
        self.k = TokenLinear(dim, dim, bias=qkv_bias)
        self.proj = TokenLinear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = group_norm_divisor(dim, divisor)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        """Under a spatial shard ``x`` holds this rank's tokens: the sr-conv
        runs on the rank's rows (its windows cover whole /32 rows), its
        output is gathered whole on every rank, and the norm and the keys
        are computed on all M tokens; the queries stay local."""
        b, n, c = x.shape
        q = self.q(x)
        if self.sr_ratio > 1:
            xs = all_gather_rows(self.sr(x.reshape(b, hw[0], hw[1], c)))
            with sharded(None):  # the gathered tokens are whole
                x_kv = self.norm(xs.reshape(b, -1, c))
        else:
            x_kv = all_gather_rows(x.reshape(b, hw[0], hw[1], c))
            x_kv = x_kv.reshape(b, -1, c)
        k = self.k(x_kv)
        out = maxpool_attention(x, q, k, self.num_heads, self.scale)
        return self.proj(out)


class Block(nn.Module):
    """Pre-norm residual block (ref Block, :111-145):
    x + DropPath(Attn(GN(x))); x + DropPath(MixFFN(GN(x)))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 sr_ratio: int, drop_path: float = 0.0, qkv_bias: bool = True,
                 divisor: int = 16):
        super().__init__()
        self.norm1 = group_norm_divisor(dim, divisor)
        self.attn = MaxPoolAttention(dim, num_heads, sr_ratio, qkv_bias,
                                     divisor)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = group_norm_divisor(dim, divisor)
        self.mlp1 = MixFFN(dim, int(dim * mlp_ratio), dim, divisor)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        x = x + self.drop_path1(self.attn(self.norm1(x), hw))
        return x + self.drop_path2(self.mlp1(self.norm2(x), hw))


class OverlapPatchEmbed(nn.Module):
    """Strided overlap conv + GroupNorm (ref :148-188). NHWC in and out."""

    def __init__(self, in_ch: int, features: int, patch_size: int,
                 stride: int, divisor: int = 16):
        super().__init__()
        self.proj = Conv2d(in_ch, features, patch_size, stride,
                           patch_size // 2)
        self.norm = group_norm_divisor(features, divisor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(x))


class SimplifiedTransformer(nn.Module):
    """4-stage encoder; returns the per-stage NHWC feature maps at /4, /8,
    /16 and /32 (ref SimplifiedTransformer.forward_features, :265-306)."""

    PATCH = ((7, 4), (3, 2), (3, 2), (3, 2))

    def __init__(self, in_ch: int, dims: Sequence[int],
                 num_heads: Sequence[int], mlp_ratios: Sequence[int],
                 sr_ratios: Sequence[int], depths: Sequence[int],
                 drop_path_rate: float = 0.1, qkv_bias: bool = True,
                 divisor: int = 16, remat_blocks: bool = False):
        super().__init__()
        # recompute each block in the backward pass (remat_encoder)
        self.remat_blocks = remat_blocks
        # linear stochastic-depth decay across all blocks (ref :214)
        dpr = np.linspace(0.0, drop_path_rate, sum(depths))
        chans = [in_ch] + list(dims[:-1])
        cur = 0
        for i in range(4):
            patch, stride = self.PATCH[i]
            setattr(self, f"patch_embed{i + 1}", OverlapPatchEmbed(
                chans[i], dims[i], patch, stride, divisor))
            setattr(self, f"block{i + 1}", nn.ModuleList([
                Block(dims[i], num_heads[i], mlp_ratios[i], sr_ratios[i],
                      float(dpr[cur + j]), qkv_bias, divisor)
                for j in range(depths[i])
            ]))
            cur += depths[i]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for i in range(4):
            x = getattr(self, f"patch_embed{i + 1}")(x)
            b, h, w, c = x.shape
            tok = x.reshape(b, h * w, c)
            for blk in getattr(self, f"block{i + 1}"):
                if self.remat_blocks and torch.is_grad_enabled():
                    tok = remat(blk, tok, (h, w))
                else:
                    tok = blk(tok, (h, w))
            x = tok.reshape(b, h, w, c)
            outs.append(x)
        return outs
