"""CamRaDepth: camera+radar depth estimation, PyTorch port.

Counterpart of ``camradepth_tpu/models/camradepth.py``: the encoder, the
1x1 skip convs, five decoder stages and three depth heads, with the
optional supervised and unsupervised seg branches, whose argmax maps guide
the depth heads (``:151-244``), and the optional ``tpu_decoder`` variant.
Input is NHWC ``[B, H, W, C_in]``; the output is the JAX package's nested
dict, in fp32:

  {"depth": {"final_depth": [B,H,W,1],
             "intermediate_depths": (None, None, d3 [B,H/4,W/4,1],
                                     d4 [B,H/2,W/2,1])},
   "seg":   {"final_seg": [B,H,W,num_classes] | None,
             "intermediate_seg": [B,H/2,W/2,num_classes] | None,
             "unsup_map": [B,H,W,1] | None}}

Parameter names and shapes are the reference ``state_dict`` layout (the
key scheme of ``tests/torch_mirror.py``: ``seg_upsample.{0,1}``,
``seg_conv_stage_4``, ``seg_conv_final``, ``unsup_stage_4``,
``unsup_final``), so a reference checkpoint loads with
``load_state_dict(strict=True)``. The ``tpu_decoder`` variant has no
reference layout: its stages take the parity stages' names
(``depth_upsample.3``, ``depth_upsample.4``, ``seg_upsample.0``,
``seg_upsample.1``), each a :class:`TPUDecoder` with children
``conv_0`` .. ``conv_2`` (ConvLayers: ``conv_0.model.0.weight``,
``conv_0.model.1.weight``, ...), and ``depth_activation_5`` is a
:class:`SubpixelDepthActivation` (``conv_1``, ``conv_2``). For inference
the weights are held in the compute dtype (4-D conv weights in
``channels_last``); for training (``create_model(..., train=True)``) they
stay fp32, as the JAX package's params do, and each layer casts its weight
to the compute dtype at use. GroupNorm affines stay fp32 in both.
``remat_*`` recompute encoder blocks or decoder stages in the backward
pass; dropout draws from the generator given to
:meth:`CamRaDepth.set_generator`.
"""

from __future__ import annotations

import functools
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
    SegConv,
    SubpixelDepthActivation,
    TokenLinear,
    TPUDecoder,
    depth_to_space,
    remat,
    seg_block,
    space_to_depth,
)
from camradepth_tpu_torch.parallel import spatial

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class CamRaDepth(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(_DTYPES)}")
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.compute_dtype]
        dims, mid, c_in = cfg.dims, cfg.mid_channels, cfg.input_channels
        n_seg = int(cfg.supervised_seg) + int(cfg.unsupervised_seg)
        self.dest_encoder = SimplifiedTransformer(
            c_in, dims, cfg.heads, cfg.ff_expansion,
            cfg.sr_ratios, cfg.depths, cfg.drop_path_rate, cfg.qkv_bias,
            cfg.groupnorm_divisor, remat_blocks=cfg.remat_encoder,
        )
        # 1x1 skip convs (CamRaDepth.py:61-64, 109-112)
        self.from_encoder_1 = ConvLayer(dims[3], dims[3], 1, 1, 0)
        self.from_encoder_2 = ConvLayer(dims[2], dims[2], 1, 1, 0)
        self.from_encoder_3 = ConvLayer(dims[1], dims[1], 1, 1, 0)
        self.from_encoder_4 = ConvLayer(dims[0], dims[0], 1, 1, 0)
        # the half- and full-resolution stages: parity Decoders, or the
        # variant's TPUDecoders, which stay at half resolution through the
        # last stage (camradepth_tpu/models/camradepth.py:135-139, 189-209)
        if cfg.tpu_decoder:
            half = functools.partial(TPUDecoder, mid + 1, mid)
            full = functools.partial(TPUDecoder, mid + 1, mid, c_in,
                                     upsample_out=False)
        else:
            half = functools.partial(Decoder, mid + 1, mid)
            full = functools.partial(Decoder, mid + 1, mid, c_in)
        # depth decoder (CamRaDepth.py:115-149)
        self.depth_upsample = nn.ModuleList([
            Decoder(dims[3], mid, dims[2]),
            Decoder(mid, mid, dims[1]),
            Decoder(mid, mid, dims[0]),
            half(),
            full(),
        ])
        self.depth_activation_3 = DepthActivation(mid)
        self.depth_activation_4 = DepthActivation(mid + n_seg)
        if cfg.tpu_decoder:
            # the guidance maps re-enter the half-resolution head by
            # space_to_depth: 4 channels each
            self.depth_activation_5 = SubpixelDepthActivation(
                mid + 4 * n_seg)
        else:
            self.depth_activation_5 = DepthActivation(mid + n_seg)
        if n_seg:
            self.seg_upsample = nn.ModuleList([half(), full()])
        # the final seg heads of the variant emit 4 logits per class at
        # half resolution for a depth_to_space
        mul = 4 if cfg.tpu_decoder else 1
        if cfg.supervised_seg:
            self.seg_conv_stage_4 = SegConv(mid, cfg.num_classes)
            self.seg_conv_final = SegConv(mid, mul * cfg.num_classes)
        if cfg.unsupervised_seg:
            self.unsup_stage_4 = SegConv(mid, cfg.unsup_classes)
            self.unsup_final = SegConv(mid, mul * cfg.unsup_classes)
        self.dropout = Dropout2d(cfg.dropout_rate)

    # this rank's rows of the global batch (parallel/multihost.BatchShard);
    # None on one device
    batch_shard = None
    # this rank's rows of every image under spatially sharded training
    # (parallel/spatial.RowShard, set by parallel/mesh.wrap); None else
    row_shard = None

    def set_generator(self, generator: Optional[torch.Generator]) -> None:
        """Draw every dropout mask (DropPath, Dropout2d) from
        ``generator``."""
        for mod in self.modules():
            if isinstance(mod, (DropPath, Dropout2d)):
                mod.generator = generator

    def set_batch_shard(self, shard) -> None:
        """Run on rows ``shard.index`` of ``shard.count`` equal shares of
        the global batch (``parallel/mesh.wrap``): every dropout mask is
        drawn for the global batch and cut to these rows. Not for an sp
        group, whose ranks each hold the whole batch and draw the whole
        batch's masks (:attr:`row_shard`)."""
        self.batch_shard = shard
        for mod in self.modules():
            if isinstance(mod, (DropPath, Dropout2d)):
                mod.shard = shard

    def _stage(self, stage: nn.Module, *args, small: bool = False):
        """A decoder stage, followed by channel dropout, recomputed in the
        backward pass under ``remat_decoder`` (every stage) or, for the
        three stages up to quarter resolution (``small``),
        ``remat_decoder_small`` (camradepth_tpu/models/camradepth.py:
        85-110)."""
        cfg = self.cfg
        if torch.is_grad_enabled() and (
                cfg.remat_decoder or (small and cfg.remat_decoder_small)):
            return self.dropout(remat(stage, *args))
        return self.dropout(stage(*args))

    def _guidance(self, logits: Optional[torch.Tensor],
                  unsup: Optional[torch.Tensor], dtype: torch.dtype):
        """The supervised and unsupervised argmax maps of one stage's seg
        logits (fp32 from the heads, rounded to the compute dtype as the
        JAX heads round them), and their concat, the guidance map."""
        n_sup, n_unsup = self.cfg.num_classes, self.cfg.unsup_classes
        sup = None if logits is None else seg_block(logits.to(dtype), n_sup)
        uns = None if unsup is None else seg_block(unsup.to(dtype), n_unsup)
        maps = [m for m in (sup, uns) if m is not None]
        return sup, uns, (torch.cat(maps, dim=-1) if maps else None)

    def forward(self, x: torch.Tensor) -> dict:
        """The outputs of the module docstring for input ``x`` [B, H, W,
        C_in]. Under a spatial shard (``parallel/spatial.sharded``) ``x``
        holds this rank's input rows and every output this rank's rows of
        it; every variant runs so."""
        cfg = self.cfg
        if x.shape[-1] != cfg.input_channels:
            raise ValueError(
                f"expected {cfg.input_channels} input channels (NHWC), got "
                f"{x.shape[-1]}"
            )
        shard = spatial.active()
        if shard is not None and shard.factor(x.shape[1]) != spatial.ROW_UNIT:
            raise ValueError(
                f"rank {shard.index} of the sp group owns "
                f"{shard.counts[shard.index] * spatial.ROW_UNIT} input rows, "
                f"got {x.shape[1]}")
        x = x.to(self.dtype)
        lay = self.dest_encoder(x)
        enc1 = self.from_encoder_1(lay[3])
        enc2 = self.from_encoder_2(lay[2])
        enc3 = self.from_encoder_3(lay[1])
        enc4 = self.from_encoder_4(lay[0])
        up = self._stage
        ups = self.depth_upsample
        d = up(ups[0], enc1, enc2, small=True)
        d = up(ups[1], d, enc3, small=True)
        d = up(ups[2], d, enc4, small=True)
        inter_depth_3 = self.depth_activation_3(d)
        d = torch.cat([d, inter_depth_3.to(d.dtype)], dim=-1)
        d4 = up(ups[3], d)

        use_seg = cfg.supervised_seg or cfg.unsupervised_seg
        seg_inter = unsup_logits = None
        if use_seg:
            seg_features = up(self.seg_upsample[0], d)
            if cfg.supervised_seg:
                seg_inter = self.seg_conv_stage_4(seg_features)
            if cfg.unsupervised_seg:
                unsup_logits = self.unsup_stage_4(seg_features)
            sup_map, unsup_map, seg_map = self._guidance(
                seg_inter, unsup_logits, d4.dtype)
            # the supervised map, else the unsupervised one, goes on with
            # the seg features (camradepth_tpu/models/camradepth.py:173-176)
            seg_features = torch.cat(
                [seg_features, sup_map if sup_map is not None
                 else unsup_map], dim=-1)
            tmp = torch.cat([d4, seg_map], dim=-1)
        else:
            tmp = d4
        inter_depth_4 = self.depth_activation_4(tmp)
        d4 = torch.cat([d4, inter_depth_4.to(d4.dtype)], dim=-1)

        # final stage with the raw input as skip (CamRaDepth.py:149)
        d5 = up(ups[4], d4, x)
        seg_final = unsup_map = None
        tmp = d5
        if use_seg:
            seg_features = up(self.seg_upsample[1], seg_features, x)
            if cfg.supervised_seg:
                seg_final = self.seg_conv_final(seg_features)
            if cfg.unsupervised_seg:
                unsup_logits = self.unsup_final(seg_features)
            if cfg.tpu_decoder:
                # the subpixel heads: rounded, then depth_to_space
                seg_final, unsup_logits = (
                    None if v is None else depth_to_space(v.to(d5.dtype))
                    for v in (seg_final, unsup_logits))
            _, unsup_map, seg_map = self._guidance(seg_final, unsup_logits,
                                                   d5.dtype)
            tmp = torch.cat([d5, space_to_depth(seg_map) if cfg.tpu_decoder
                             else seg_map], dim=-1)
        final_depth = self.depth_activation_5(tmp)

        def f32(v):
            return None if v is None else v.float()

        return {
            "depth": {
                "intermediate_depths": (
                    None, None, inter_depth_3, inter_depth_4
                ),
                "final_depth": f32(final_depth),
            },
            "seg": {"final_seg": f32(seg_final),
                    "intermediate_seg": seg_inter,
                    "unsup_map": f32(unsup_map)},
        }


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Fresh weights drawn from ``generator``, with the JAX package's
    initializers: trunc-normal(0.02) token projections, kaiming-normal
    (fan_out) convs with zero bias, torch-default depth and seg heads
    (``layers.py:24-51``), GroupNorm 1/0."""
    heads = (DepthActivation, SubpixelDepthActivation, SegConv)
    head_convs = {id(m) for h in model.modules()
                  if isinstance(h, heads) for m in h.modules()}
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
    CUDA and no card is there. On ``device="meta"`` the model holds no
    weights (shapes and dtypes only; ``utils/roofline.py``).
    """
    if torch.device(device).type == "meta":
        if state_dict is not None:
            raise ValueError("a meta model takes no state_dict")
        with torch.device("meta"):
            model = CamRaDepth(cfg)
        _to_compute_dtype(model, train)
        return model.train() if train else model.eval()
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
