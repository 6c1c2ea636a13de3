"""RAFT optical flow (raft-large), with the official checkpoint's keys.

Counterpart of ``camradepth_tpu/models/raft.py``, the offline prep's flow
estimator ("RAFT: Recurrent All-Pairs Field Transforms for Optical Flow",
Teed & Deng, ECCV 2020; the reference runs the official torch model in
scripts/cal_flow.py:18-93). The modules are laid out as the official
``core/raft.py`` lays them out, so :class:`RAFT`'s ``state_dict`` is the
official raft-large key set: an official ``raft-things.pth`` loads with
``load_state_dict`` (:func:`load_official_state_dict` strips the
DataParallel ``module.`` prefix), with no converter. As the JAX package
and the official checkpoints have it:

- the feature encoder ``fnet`` uses InstanceNorm with no affine (the
  checkpoints hold no ``fnet.norm*`` keys); the context encoder ``cnet``
  uses BatchNorm, frozen: the module stays in eval mode, with the
  checkpoint's running statistics, and a stride-2 block registers its
  downsample norm twice (``norm3`` and ``downsample.1``);
- the correlation pyramid is one all-pairs batched matmul in fp32,
  average-pooled 2x over the target axes for 4 levels;
- each of the ``iters`` refinements looks up a (2r+1)^2 neighbourhood of
  every level around coords0 + flow, the taps in the official channel
  order (x offset outer), by a zero-padded bilinear gather, where the JAX
  package contracts one-hot weight matrices;
- the flow at 1/8 resolution is carried as a sum of the updates (as the
  JAX package carries it) and upsampled 8x by the convex combination of
  its 3x3 neighbourhood (``F.unfold``).

Tensors are NCHW inside; :class:`RAFT` takes and returns NHWC, as the JAX
module does. No JAX function here has a Pallas original.
"""

from __future__ import annotations

from typing import Callable, List, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from camradepth_tpu_torch import resolve_device


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        self.relu = nn.ReLU(inplace=True)
        norm = (nn.BatchNorm2d if norm_fn == "batch"
                else nn.InstanceNorm2d)
        self.norm1 = norm(planes)
        self.norm2 = norm(planes)
        if stride == 1:
            self.downsample = None
        else:
            self.norm3 = norm(planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride), self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class BasicEncoder(nn.Module):
    """fnet / cnet: 1/8-resolution features of ``output_dim`` channels."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "instance"):
        super().__init__()
        self.norm1 = (nn.BatchNorm2d(64) if norm_fn == "batch"
                      else nn.InstanceNorm2d(64))
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.relu1 = nn.ReLU(inplace=True)
        layers, cin = [], 64
        for dim, stride in ((64, 1), (96, 2), (128, 2)):
            layers.append(nn.Sequential(
                ResidualBlock(cin, dim, norm_fn, stride),
                ResidualBlock(dim, dim, norm_fn, 1)))
            cin = dim
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.relu1(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                 num_levels: int = 4) -> List[torch.Tensor]:
    """All-pairs correlation of NCHW feature maps, [B, H*W, H/2^l, W/2^l]
    per level: one batched fp32 matmul divided by sqrt(C), then 2x2
    average pools over the target axes (odd rows and columns dropped)."""
    b, c, h, w = fmap1.shape
    f1 = fmap1.float().reshape(b, c, h * w)
    f2 = fmap2.float().reshape(b, c, h * w)
    corr = torch.matmul(f1.transpose(1, 2), f2) / torch.sqrt(
        torch.tensor(float(c)))
    corr = corr.reshape(b, h * w, h, w)
    pyr = [corr]
    for _ in range(num_levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyr.append(corr)
    return pyr


def lookup_corr(pyr: List[torch.Tensor], flow: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """Each level sampled on a (2r+1)^2 grid centred at coords0 + flow
    (flow NCHW [B, 2, H, W], x then y), zero outside the level: [B,
    L*(2r+1)^2, H, W], tap (a, b) of a level at channel a*(2r+1) + b for x
    offset a - r and y offset b - r (the official CorrBlock's order)."""
    b, n, h, w = pyr[0].shape
    dev = flow.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    cx = (xs + flow[:, 0]).reshape(b, n)
    cy = (ys + flow[:, 1]).reshape(b, n)
    k = 2 * radius + 1
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)
    outs = []
    for lvl, corr in enumerate(pyr):
        hl, wl = corr.shape[2], corr.shape[3]
        scale = 2.0 ** lvl
        # [B, N, k] coordinates of the taps in level space
        lx = cx[..., None] / scale + offs
        ly = cy[..., None] / scale + offs
        x0, y0 = torch.floor(lx), torch.floor(ly)
        wx1, wy1 = lx - x0, ly - y0
        flat = corr.reshape(b, n, hl * wl)
        acc = flat.new_zeros((b, n, k, k))  # [x tap, y tap]
        for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
            yi = y0 + dy
            yok = (yi >= 0) & (yi <= hl - 1)
            for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
                xi = x0 + dx
                xok = (xi >= 0) & (xi <= wl - 1)
                idx = (yi.clamp(0, hl - 1)[:, :, None, :] * wl
                       + xi.clamp(0, wl - 1)[:, :, :, None]).long()
                val = torch.gather(flat, 2, idx.reshape(b, n, k * k))
                wgt = ((wx * xok)[:, :, :, None] * (wy * yok)[:, :, None, :])
                acc = acc + val.reshape(b, n, k, k) * wgt
        outs.append(acc.reshape(b, h, w, k * k))
    return torch.cat(outs, dim=-1).permute(0, 3, 1, 2).contiguous()


class PaddedConv2d(nn.Conv2d):
    """``nn.Conv2d`` computed with its output channels padded to a multiple
    of 256 (zero filters) and cut back; its parameters keep their shapes.
    On the H100 in fp32 (TF32 off) cuDNN takes 200-210 ms for a 3x3 conv
    from 256 channels at 113x200 to 128 or 192 channels and 20.5 ms to
    126, against 0.75 ms to 256 (``tools/port_raft_convs.py``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = -self.out_channels % 256
        if pad == 0:
            return super().forward(x)
        w = F.pad(self.weight, (0, 0, 0, 0, 0, 0, 0, pad))
        b = None if self.bias is None else F.pad(self.bias, (0, pad))
        y = F.conv2d(x, w, b, self.stride, self.padding, self.dilation,
                     self.groups)
        return y[:, :self.out_channels]


class BasicMotionEncoder(nn.Module):
    def __init__(self, cor_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, 256, 1, padding=0)
        self.convc2 = PaddedConv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = PaddedConv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        cin = hidden_dim + input_dim
        for s, kern, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for g in "zrq":
                setattr(self, f"conv{g}{s}",
                        nn.Conv2d(cin, hidden_dim, kern, padding=pad))

    def forward(self, h, x):
        for s in "12":
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{s}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{s}")(hx))
            q = torch.tanh(getattr(self, f"convq{s}")(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        return self.conv2(self.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, cor_planes: int, hidden_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(cor_planes)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(
            nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(256, 64 * 9, 1, padding=0))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """8x convex upsampling of NCHW ``flow`` [B, 2, H, W] by ``mask`` [B,
    576, H, W]: each output pixel a softmax-weighted combination of the
    3x3 neighbourhood of 8 x the coarse flow. Returns [B, 2, 8H, 8W]."""
    b, _, h, w = flow.shape
    m = torch.softmax(mask.reshape(b, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8.0 * flow, [3, 3], padding=1).reshape(b, 2, 9, 1, 1, h, w)
    up = torch.sum(m * up, dim=2)  # [B, 2, 8, 8, H, W]
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, 2, 8 * h, 8 * w)


class RAFT(nn.Module):
    """raft-large. ``forward(im1, im2)`` takes NHWC [B, H, W, 3] RGB in
    0..255 (the official input convention), H and W multiples of 8, and
    returns the upsampled flow [B, H, W, 2] (fp32, dx then dy)."""

    def __init__(self, iters: int = 20, corr_levels: int = 4,
                 corr_radius: int = 4):
        super().__init__()
        self.iters, self.corr_levels = iters, corr_levels
        self.corr_radius = corr_radius
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(256, "batch")
        self.update_block = BasicUpdateBlock(
            corr_levels * (2 * corr_radius + 1) ** 2, 128)

    def train(self, mode: bool = True):
        # frozen BatchNorm: the estimator only runs in eval semantics
        return super().train(False)

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        im1 = 2.0 * (im1.permute(0, 3, 1, 2).float() / 255.0) - 1.0
        im2 = 2.0 * (im2.permute(0, 3, 1, 2).float() / 255.0) - 1.0
        fmap1, fmap2 = self.fnet(im1), self.fnet(im2)
        pyr = corr_pyramid(fmap1, fmap2, self.corr_levels)
        cnet = self.cnet(im1)
        net = torch.tanh(cnet[:, :128])
        inp = torch.relu(cnet[:, 128:])
        b, _, h8, w8 = fmap1.shape
        flow = fmap1.new_zeros((b, 2, h8, w8), dtype=torch.float32)
        mask = None
        for _ in range(self.iters):
            corr = lookup_corr(pyr, flow, self.corr_radius)
            net, mask, delta = self.update_block(net, inp, corr, flow)
            flow = flow + delta
        return convex_upsample(flow, mask).permute(0, 2, 3, 1)


def load_official_state_dict(model: RAFT, state: Mapping) -> RAFT:
    """Load an official RAFT checkpoint's state_dict (tensors or numpy
    arrays; ``module.``-prefixed keys as DataParallel saves them)
    strictly into ``model``."""
    sd = {k.removeprefix("module."): (v if torch.is_tensor(v)
                                      else torch.as_tensor(np.asarray(v)))
          for k, v in state.items()}
    model.load_state_dict(sd, strict=True)
    return model


def raft_flow_fn(state: Mapping, iters: int = 20,
                 device="cuda") -> Callable:
    """(im1, im2) -> flow over an official checkpoint's ``state``:
    [B, H, W, 3] RGB 0..255 in (numpy or tensors), the [B, H, W, 2] fp32
    flow tensor on ``device`` out."""
    dev = resolve_device(device)
    model = load_official_state_dict(RAFT(iters=iters), state).to(dev).eval()

    def as_input(im):
        # a numpy view may run backwards (the prep's BGR -> RGB flip)
        if isinstance(im, np.ndarray):
            im = np.ascontiguousarray(im)
        return torch.as_tensor(im, device=dev)

    @torch.no_grad()
    def run(im1, im2) -> torch.Tensor:
        return model(as_input(im1), as_input(im2))

    return run
