"""Panoptic-DeepLab, R101-os32 Cityscapes, for the offline prep's
vehicle segmentation.

Counterpart of ``camradepth_tpu/models/panoptic_deeplab.py`` ("Panoptic-
DeepLab: A Simple, Strong, and Fast Baseline for Bottom-Up Panoptic
Segmentation", Cheng et al., CVPR, 2020; the reference shells out to the
official torch model in scripts/semantic_seg.py:89-171):

- a ResNet-101 backbone (torchvision v1.5 layout, the stride on the 3x3,
  os32 with no dilation), BatchNorm frozen from the checkpoint's running
  statistics;
- two ASPPs (a 1x1, three 3x3 at rates 3, 6, 9, image pooling; then a 1x1
  project) and two light decoders (semantic: 256 wide, res3 -> 64 and
  res2 -> 32 skips; instance: 128 wide, -> 32 and -> 16), each skip
  projected, the coarser map upsampled to it (bilinear, align_corners),
  concatenated and fused by a 5x5 depthwise-separable conv;
- heads: semantic 256 -> 19 logits, center 32 -> 1 and offset 32 -> 2.

The modules are named as the state_dict that the JAX package's tests
synthesize for the official ``panoptic_deeplab_R101_os32_cityscapes.pth``
(``tests/test_panoptic_deeplab.py``), so such a state_dict loads with
``load_state_dict``. The official repo is not vendored, so its exact key
strings are a reconstruction; :func:`load_state_dict_by_order` therefore
also loads any state_dict of the same architecture by registration order
and shape, whatever its names, as the JAX loader does (676 tensors besides
``num_batches_tracked``). NCHW inside; the model takes the normalized
NHWC image and returns NHWC maps at 1/4 resolution, as the JAX module.
:func:`classmap_fn` is the prep's estimator contract: mean-pad to the
reference's odd size, normalize, forward, upsample the logits, argmax,
crop. No JAX function here has a Pallas original.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from camradepth_tpu_torch import resolve_device

# Cityscapes trainIds: 13 car, 14 truck, 15 bus (semantic_seg.py:165).
VEHICLE_CLASSES = (13, 14, 15)
NUM_CLASSES = 19
# Pixel-scale ImageNet statistics (semantic_seg.py:150-152).
MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)
# tensors of the architecture's state_dict besides num_batches_tracked
NUM_TENSORS = 676


def resize_bilinear_ac(x: torch.Tensor, out_hw: Tuple[int, int]):
    """align_corners=True bilinear resize of NHWC ``x`` (torch's
    ``F.interpolate`` semantics, which the upstream decoder uses)."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw),
                      mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1)


def _up(x: torch.Tensor, hw) -> torch.Tensor:
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=True)


def conv_bn(cin: int, cout: int, k: int, stride: int = 1,
            dilation: int = 1, relu: bool = True, groups: int = 1):
    """conv (no bias) + BatchNorm (+ ReLU): keys ``0`` and ``1``."""
    pad = dilation * (k - 1) // 2
    mods = [nn.Conv2d(cin, cout, k, stride=stride, padding=pad,
                      dilation=dilation, groups=groups, bias=False),
            nn.BatchNorm2d(cout)]
    if relu:
        mods.append(nn.ReLU(inplace=True))
    return nn.Sequential(*mods)


def sep_conv(cin: int, cout: int, k: int = 5):
    """5x5 depthwise conv-bn-relu, then 1x1 pointwise conv-bn-relu."""
    return nn.Sequential(conv_bn(cin, cin, k, groups=cin),
                         conv_bn(cin, cout, 1))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv_bn(cin, planes, 1, relu=False)
        self.conv2 = conv_bn(planes, planes, 3, stride=stride, relu=False)
        self.conv3 = conv_bn(planes, planes * 4, 1, relu=False)
        self.downsample = (
            conv_bn(cin, planes * 4, 1, stride=stride, relu=False)
            if (stride != 1 or cin != planes * 4) else None)

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        skip = x if self.downsample is None else self.downsample(x)
        return F.relu(out + skip)


class ResNet101(nn.Module):
    """{res2: /4 256, res3: /8 512, res4: /16 1024, res5: /32 2048}."""

    def __init__(self, layers=(3, 4, 23, 3)):
        super().__init__()
        self.stem = conv_bn(3, 64, 7, stride=2)
        cin, planes = 64, 64
        for li, n in enumerate(layers):
            blocks = []
            for bi in range(n):
                blocks.append(Bottleneck(
                    cin, planes, stride=2 if (li and bi == 0) else 1))
                cin = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            planes *= 2

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = F.max_pool2d(self.stem(x), 3, stride=2, padding=1)
        feats = {}
        for li in range(4):
            x = getattr(self, f"layer{li + 1}")(x)
            feats[f"res{li + 2}"] = x
        return feats


class ASPP(nn.Module):
    def __init__(self, cin: int, cout: int, rates=(3, 6, 9)):
        super().__init__()
        self.convs = nn.ModuleList(
            [conv_bn(cin, cout, 1)]
            + [conv_bn(cin, cout, 3, dilation=r) for r in rates]
            + [conv_bn(cin, cout, 1)])  # the image-pooling branch
        self.project = conv_bn(cout * 5, cout, 1)

    def forward(self, x):
        outs = [m(x) for m in self.convs[:-1]]
        pooled = self.convs[-1](x.mean((2, 3), keepdim=True))
        outs.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        return self.project(torch.cat(outs, 1))


class SingleDecoder(nn.Module):
    """ASPP, then per low level (res3, res2): project, upsample the
    coarser map to it, concat, 5x5 separable fuse."""

    def __init__(self, aspp_ch: int, dec_ch: int, proj_ch,
                 low_ch=(512, 256)):
        super().__init__()
        self.aspp = ASPP(2048, aspp_ch)
        self.project = nn.ModuleList(
            [conv_bn(lc, pc, 1) for lc, pc in zip(low_ch, proj_ch)])
        self.fuse = nn.ModuleList([
            sep_conv(aspp_ch + proj_ch[0], dec_ch),
            sep_conv(dec_ch + proj_ch[1], dec_ch)])

    def forward(self, res5, lows):
        x = self.aspp(res5)
        for proj, fuse, low in zip(self.project, self.fuse, lows):
            low = proj(low)
            x = fuse(torch.cat([_up(x, low.shape[2:]), low], 1))
        return x


class Head(nn.Module):
    """5x5 separable conv -> 1x1 predictor (bias, no BN)."""

    def __init__(self, cin: int, head_ch: int, nout: int):
        super().__init__()
        self.head_conv = sep_conv(cin, head_ch)
        self.predictor = nn.Conv2d(head_ch, nout, 1, bias=True)

    def forward(self, x):
        return self.predictor(self.head_conv(x))


class PanopticDeepLab(nn.Module):
    """R101-os32 Cityscapes Panoptic-DeepLab in inference semantics (frozen
    BatchNorm). ``forward(x)`` takes the normalized NHWC image [B, H, W,
    3] and returns semantic [B, h, w, 19], center [B, h, w, 1] and offset
    [B, h, w, 2] at 1/4 resolution, fp32."""

    def __init__(self):
        super().__init__()
        self.backbone = ResNet101()
        self.semantic_decoder = SingleDecoder(256, 256, (64, 32))
        self.semantic_head = Head(256, 256, NUM_CLASSES)
        self.instance_decoder = SingleDecoder(256, 128, (32, 16))
        self.center_head = Head(128, 32, 1)
        self.offset_head = Head(128, 32, 2)

    def train(self, mode: bool = True):
        # frozen BatchNorm: the estimator only runs in eval semantics
        return super().train(False)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.backbone(x.permute(0, 3, 1, 2))
        lows = [feats["res3"], feats["res2"]]
        sem = self.semantic_decoder(feats["res5"], lows)
        ins = self.instance_decoder(feats["res5"], lows)
        out = {"semantic": self.semantic_head(sem),
               "center": self.center_head(ins),
               "offset": self.offset_head(ins)}
        return {k: v.float().permute(0, 2, 3, 1) for k, v in out.items()}


def load_state_dict_by_order(model: PanopticDeepLab,
                             state: Mapping) -> PanopticDeepLab:
    """Load a state_dict of the architecture by registration order and
    shape, whatever its key names (``num_batches_tracked`` dropped), as
    the JAX package's ``load_torch_panoptic_deeplab`` does; a wrong count
    or shape raises, naming the tensor."""
    items = [(k, v) for k, v in state.items()
             if not k.endswith("num_batches_tracked")]
    own = [(k, v) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")]
    if len(items) != len(own):
        raise ValueError(
            f"checkpoint has {len(items)} tensors (after dropping "
            f"num_batches_tracked), the architecture expects {len(own)}: "
            "not a Panoptic-DeepLab R101-os32 state_dict?")
    sd = {}
    for (key, value), (name, ref) in zip(items, own):
        value = (value if torch.is_tensor(value)
                 else torch.as_tensor(np.asarray(value)))
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch at {key} ({name}): checkpoint "
                             f"{tuple(value.shape)} vs architecture "
                             f"{tuple(ref.shape)}")
        sd[name] = value
    model.load_state_dict(sd, strict=False)
    return model


def _pad_hw(h: int, w: int) -> Tuple[int, int]:
    """The reference's pad rule (semantic_seg.py:147-149): (n+31)//32*32 +
    1, whose odd size keeps the align_corners resizes lattice-exact."""
    return (h + 31) // 32 * 32 + 1, (w + 31) // 32 * 32 + 1


def classmap_fn(model: PanopticDeepLab, device="cuda") -> Callable:
    """``estimator(im [H,W,3] RGB uint8) -> [H,W] int64`` Cityscapes
    trainId map (the prep's seg-estimator contract): mean-pad to
    :func:`_pad_hw`, normalize, forward, upsample the semantic logits to the
    padded size (align_corners), argmax, crop, as semantic_seg.py does."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    mean = torch.tensor(MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(STD, dtype=torch.float32, device=dev)

    @torch.no_grad()
    def estimator(im: np.ndarray) -> np.ndarray:
        h, w = im.shape[:2]
        ph, pw = _pad_hw(h, w)
        canvas = mean.expand(ph, pw, 3).clone()  # mean-pad (ref quirk)
        # np.ascontiguousarray: the prep hands in a BGR -> RGB flipped view
        canvas[:h, :w] = torch.as_tensor(np.ascontiguousarray(im),
                                         device=dev).float()
        x = (canvas - mean) / std
        logits = model(x[None])["semantic"]
        logits = resize_bilinear_ac(logits, (ph, pw))
        cls = torch.argmax(logits, dim=-1)[0, :h, :w]
        return cls.cpu().numpy().astype(np.int64)

    return estimator
