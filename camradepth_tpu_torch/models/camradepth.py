"""CamRaDepth: camera+radar depth estimation, PyTorch port.

Counterpart of the parity path of ``camradepth_tpu/models/camradepth.py``
(``:115-141``, ``:179-183``, ``:200-204``, ``:238-259``): the encoder, the
1x1 skip convs, five bicubic decoder stages and three depth heads, with no
seg branch and the reference decoder. Input is NHWC ``[B, H, W, C_in]``;
the output is the JAX package's nested dict, in fp32:

  {"depth": {"final_depth": [B,H,W,1],
             "intermediate_depths": (None, None, d3 [B,H/4,W/4,1],
                                     d4 [B,H/2,W/2,1])},
   "seg":   {"final_seg": None, "intermediate_seg": None, "unsup_map": None}}

Parameter names and shapes are the reference ``state_dict`` layout (the
key scheme of ``tests/torch_mirror.py``), so a reference checkpoint loads
with ``load_state_dict(strict=True)``. For inference the weights are held
in the compute dtype (4-D conv weights in ``channels_last``); for training
(``create_model(..., train=True)``) they stay fp32, as the JAX package's
params do, and each layer casts its weight to the compute dtype at use.
GroupNorm affines stay fp32 in both. ``remat_*`` recompute encoder blocks
or decoder stages in the backward pass; dropout draws from the generator
given to :meth:`CamRaDepth.set_generator`.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from camradepth_tpu_torch import resolve_device
from camradepth_tpu_torch.config import ModelConfig
from camradepth_tpu_torch.models.encoder import SimplifiedTransformer
from camradepth_tpu_torch.models.layers import (
    Conv2d,
    ConvLayer,
    Decoder,
    DepthActivation,
    DropPath,
    Dropout2d,
    GroupNorm,
    TokenLinear,
    remat,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# ModelConfig options that later slices of the port bring.
_LATER = ("supervised_seg", "unsupervised_seg", "tpu_decoder")


class CamRaDepth(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        for name in _LATER:
            if getattr(cfg, name):
                raise NotImplementedError(
                    f"ModelConfig.{name} is not ported yet"
                )
        if cfg.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(_DTYPES)}")
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.compute_dtype]
        dims, mid = cfg.dims, cfg.mid_channels
        self.dest_encoder = SimplifiedTransformer(
            cfg.input_channels, dims, cfg.heads, cfg.ff_expansion,
            cfg.sr_ratios, cfg.depths, cfg.drop_path_rate, cfg.qkv_bias,
            cfg.groupnorm_divisor, remat_blocks=cfg.remat_encoder,
        )
        # 1x1 skip convs (CamRaDepth.py:61-64, 109-112)
        self.from_encoder_1 = ConvLayer(dims[3], dims[3], 1, 1, 0)
        self.from_encoder_2 = ConvLayer(dims[2], dims[2], 1, 1, 0)
        self.from_encoder_3 = ConvLayer(dims[1], dims[1], 1, 1, 0)
        self.from_encoder_4 = ConvLayer(dims[0], dims[0], 1, 1, 0)
        # depth decoder (CamRaDepth.py:115-149)
        self.depth_upsample = nn.ModuleList([
            Decoder(dims[3], mid, dims[2]),
            Decoder(mid, mid, dims[1]),
            Decoder(mid, mid, dims[0]),
            Decoder(mid + 1, mid),
            Decoder(mid + 1, mid, cfg.input_channels),
        ])
        self.depth_activation_3 = DepthActivation(mid)
        self.depth_activation_4 = DepthActivation(mid)
        self.depth_activation_5 = DepthActivation(mid)
        self.dropout = Dropout2d(cfg.dropout_rate)
        # decoder stages recomputed in the backward pass: all five
        # (remat_decoder), or the three up to quarter resolution
        # (remat_decoder_small), camradepth_tpu/models/camradepth.py:85-110
        n_remat = 5 if cfg.remat_decoder else (
            3 if cfg.remat_decoder_small else 0)
        self._remat_stages = frozenset(range(n_remat))

    def set_generator(self, generator: Optional[torch.Generator]) -> None:
        """Draw every dropout mask (DropPath, Dropout2d) from
        ``generator``."""
        for mod in self.modules():
            if isinstance(mod, (DropPath, Dropout2d)):
                mod.generator = generator

    def _stage(self, i: int, *args) -> torch.Tensor:
        if i in self._remat_stages and torch.is_grad_enabled():
            return remat(self.depth_upsample[i], *args)
        return self.depth_upsample[i](*args)

    def forward(self, x: torch.Tensor) -> dict:
        cfg = self.cfg
        if x.shape[-1] != cfg.input_channels:
            raise ValueError(
                f"expected {cfg.input_channels} input channels (NHWC), got "
                f"{x.shape[-1]}"
            )
        x = x.to(self.dtype)
        lay = self.dest_encoder(x)
        enc1 = self.from_encoder_1(lay[3])
        enc2 = self.from_encoder_2(lay[2])
        enc3 = self.from_encoder_3(lay[1])
        enc4 = self.from_encoder_4(lay[0])
        up, drop = self._stage, self.dropout
        d = drop(up(0, enc1, enc2))
        d = drop(up(1, d, enc3))
        d = drop(up(2, d, enc4))
        inter_depth_3 = self.depth_activation_3(d)
        d = torch.cat([d, inter_depth_3.to(d.dtype)], dim=-1)
        d4 = drop(up(3, d))
        inter_depth_4 = self.depth_activation_4(d4)
        d4 = torch.cat([d4, inter_depth_4.to(d4.dtype)], dim=-1)
        # final stage with the raw input as skip (CamRaDepth.py:149)
        d5 = drop(up(4, d4, x))
        final_depth = self.depth_activation_5(d5)
        return {
            "depth": {
                "intermediate_depths": (
                    None, None, inter_depth_3, inter_depth_4
                ),
                "final_depth": final_depth,
            },
            "seg": {"final_seg": None, "intermediate_seg": None,
                    "unsup_map": None},
        }


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Fresh weights drawn from ``generator``, with the JAX package's
    initializers: trunc-normal(0.02) token projections, kaiming-normal
    (fan_out) convs with zero bias, torch-default depth heads
    (``layers.py:24-51``), GroupNorm 1/0."""
    head_convs = {id(m) for h in model.modules()
                  if isinstance(h, DepthActivation) for m in h.modules()}
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, TokenLinear):
                nn.init.trunc_normal_(mod.weight, std=0.02, a=-0.04, b=0.04,
                                      generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, Conv2d) and id(mod) in head_convs:
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                nn.init.uniform_(mod.weight, -bound, bound,
                                 generator=generator)
                nn.init.uniform_(mod.bias, -bound, bound, generator=generator)
            elif isinstance(mod, Conv2d):
                nn.init.kaiming_normal_(mod.weight, mode="fan_out",
                                        nonlinearity="relu",
                                        generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()


def _to_compute_dtype(model: CamRaDepth, train: bool = False) -> None:
    """Hold 4-D conv weights in channels_last (the layout cuDNN runs NHWC
    convolutions with) and, for inference, every weight but the GroupNorm
    affines in the compute dtype. Training keeps them fp32."""
    for mod in model.modules():
        if isinstance(mod, GroupNorm):
            continue
        for p in mod.parameters(recurse=False):
            if not train:
                p.data = p.data.to(model.dtype)
            if p.ndim == 4:
                p.data = p.data.contiguous(memory_format=torch.channels_last)


def create_model(
    cfg: ModelConfig,
    device="cuda",
    state_dict: Optional[Mapping[str, object]] = None,
    seed: int = 0,
    train: bool = False,
) -> CamRaDepth:
    """A CamRaDepth on ``device``: in eval mode with its weights cast once
    to the compute dtype, or with ``train=True`` in train mode with fp32
    weights, cast at each use.

    Weights come from ``state_dict`` (reference layout; numpy arrays or
    tensors, loaded strictly) or, when none is given, fresh from a
    ``torch.Generator`` seeded with ``seed``. Raises when ``device`` is
    CUDA and no card is there.
    """
    dev = resolve_device(device)
    with torch.device("meta"):
        model = CamRaDepth(cfg)
    model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    _to_compute_dtype(model, train)
    if state_dict is not None:
        model.load_state_dict(
            {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
             for k, v in state_dict.items()},
            strict=True,
        )
    model = model.to(dev)
    return model.train() if train else model.eval()
