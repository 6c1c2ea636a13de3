"""Compact wire format: loader batches that ship the information, not the
rasters, decoded on the device.

The package's own copy of ``camradepth_tpu/data/wire.py``. A wire example
holds

  image_u8    [H,W,3] uint8   the camera jpg bytes as loaded (BGR)
  radar_idx   [P]     int32   flat pixel index of every pixel that any
  radar_val   [P,R]   f32     radar channel touches, and the channels'
                              values after their host-side transforms
  gt_idx/gt_val [Pg]          the inverse-encoded lidar GT, the same way
                              (or gt_depth [H,W] f32 where sparse GT
                              would not be smaller)
  seg/seg_inter       uint8   21 classes + 255 ignore fit a byte

in place of the dense feature stack: ~8x fewer host-to-device bytes per
frame. :func:`encode_frame_wire` runs on the host in the numpy arithmetic
of ``data/channels.assemble_frame``, value for value; with
``DataConfig.native_assemble`` (the default) the package's C++ host code
(``native.py``) encodes the frame instead, bit for bit, in one pass per
group outside the interpreter lock, and a frame that it does not cover
(an fp16 or oddly strided source, a label outside uint8) takes numpy.

:func:`decode_wire_micro` rebuilds the dense batch on whatever device its
tensors lie on, bit for bit with the dense stack: the image through a
256-entry table built on the host in numpy's f32 arithmetic
(:func:`_normalize_lut`), the radar and GT points scatter-added into
zeros. The decode is no TPU kernel (XLA fuses it into the step); in eager
torch it is a handful of launches of stock ops (a gather, two
``index_add_``, a concatenation, casts), so no kernel is written for it.
One canonicalization, as in the JAX package: a -0.0 in a source raster is
"not a point" (numpy's nonzero), so the decoded map holds +0.0 where the
dense stack kept -0.0; every consumer reads both as zero.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from camradepth_tpu_torch import native
from camradepth_tpu_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ConfigError,
    DataConfig,
)
from camradepth_tpu_torch.data import channels as ch

WIRE_KEYS = ("image_u8", "radar_idx", "radar_val", "gt_idx", "gt_val")


@dataclasses.dataclass(frozen=True)
class WirePlan:
    """The fixed wire layout of a run (every batch has these shapes)."""

    radar_cap: int  # points per frame, padded
    gt_cap: int  # 0 = the GT ships dense f32
    n_radar_ch: int  # R: the channels of the sparse radar group
    # the seg label planes ride the wire only for a config that reads them
    # (resolve_wire_ship)
    ship_seg: bool = True
    ship_seg_inter: bool = True


def _roundup(n: int, to: int) -> int:
    return max(to, ((int(n) + to - 1) // to) * to)


def _radar_source_descs(arrays: Dict[str, np.ndarray], cfg: DataConfig):
    """[(source_2d, clip_desc)] for the sparse radar group, in
    assemble_frame's channel order; ``clip_desc`` is ``(lo, hi, div)`` for
    ``np.clip(v, lo, hi) / div``, or None for the identity."""
    if cfg.filtered_radar:
        # the reference hard-codes 100.0 here, not max_depth
        return [(arrays["radar_filtered"], (0.0, 100.0, 100.0))]
    radar = arrays["radar"]
    md = float(cfg.max_depth)
    groups = [(radar[..., 0], (0.0, md, md))]
    if cfg.sparse_depth_uv:
        groups += [(radar[..., 1], None), (radar[..., 2], None)]
    if cfg.rad_vel:
        groups.append((arrays["rad_vel"], None))
    return groups


def _transform(desc):
    if desc is None:
        return lambda v: v
    lo, hi, div = desc
    return lambda v: np.clip(v, lo, hi) / div


def wire_supported(cfg: DataConfig) -> bool:
    """The channel configs the codec covers: the standard radar stack and
    the filtered radar. sparse_lidar (random masks per epoch) and im_uv (a
    dense flow image) stay dense."""
    return not cfg.sparse_lidar and not cfg.im_uv


def radar_channel_count(cfg: DataConfig) -> int:
    """The sparse radar channels the codec carries for ``cfg``."""
    if cfg.filtered_radar:
        return 1
    return 1 + (2 if cfg.sparse_depth_uv else 0) + (1 if cfg.rad_vel else 0)


def plan_wire(frames_rows: Sequence, cfg: DataConfig,
              sample_n: int = 4) -> Optional[WirePlan]:
    """Probe the first frames and pick the point caps, or None where the
    config or the data does not suit the codec. The caps keep margins
    (radar 4x + 64, GT 1.5x + 1024): a denser later frame raises
    :class:`WireOverflowError` at encode time, naming the cap to set. The
    GT ships dense wherever sparse would not be smaller."""
    if not wire_supported(cfg) or len(frames_rows) == 0:
        return None
    from camradepth_tpu_torch.data.pipeline import load_frame_arrays

    h, w = cfg.image_dimension
    max_radar = max_gt = 0
    n_radar_ch = 0
    for i in range(min(sample_n, len(frames_rows))):
        arrays = load_frame_arrays(frames_rows[i], cfg)
        if arrays["image"].dtype != np.uint8 or arrays["image"].shape != (
                h, w, 3):
            return None
        groups = _radar_source_descs(arrays, cfg)
        n_radar_ch = len(groups)
        mask = np.zeros((h, w), bool)
        for s, _ in groups:
            if np.asarray(s).shape[:2] != (h, w):
                # encode_frame_wire would refuse the frame mid-epoch
                return None
            mask |= np.asarray(s) != 0
        max_radar = max(max_radar, int(mask.sum()))
        enc = ch.encode_inverse_depth(np.asarray(arrays["gt"][..., 0]),
                                      cfg.max_depth)
        max_gt = max(max_gt, int(np.count_nonzero(enc)))
    radar_cap = cfg.wire_radar_cap or _roundup(4 * max_radar + 64, 256)
    gt_cap = cfg.wire_gt_cap or _roundup(int(1.5 * max_gt) + 1024, 1024)
    # sparse GT is 8 bytes a point (int32 index, f32 value), dense 4 a pixel
    if gt_cap * 8 >= h * w * 4:
        gt_cap = 0
    # radar denser than ~1/3 of the image costs more than its dense channels
    if radar_cap * (4 + 4 * n_radar_ch) >= h * w * 4 * n_radar_ch // 2:
        return None
    return WirePlan(radar_cap=radar_cap, gt_cap=gt_cap,
                    n_radar_ch=n_radar_ch, ship_seg=cfg.wire_ship_seg,
                    ship_seg_inter=cfg.wire_ship_seg_inter)


class WireOverflowError(ValueError):
    pass


def resolve_wire_ship(cfg) -> DataConfig:
    """``cfg.data`` with ``wire_ship_seg``/``_inter`` narrowed to what the
    ExperimentConfig ``cfg`` reads: ``seg`` only with a supervised seg
    branch (its loss and the IoU), ``seg_inter`` only with
    ``train.seg_inter_loss`` on top of it. It never widens. Unlike the
    JAX package's (whose step then fails on the missing key), it raises
    :class:`ConfigError` where an explicit False drops a plane that the
    config reads."""
    sup = bool(cfg.model.supervised_seg)
    for field, needed in (("wire_ship_seg", sup),
                          ("wire_ship_seg_inter",
                           sup and bool(cfg.train.seg_inter_loss))):
        if needed and not getattr(cfg.data, field):
            raise ConfigError(
                f"data.{field}=False, but this config reads that label "
                "plane (the supervised seg loss or IoU); set it True or "
                "data.wire_format=off")
    return dataclasses.replace(
        cfg.data,
        wire_ship_seg=cfg.data.wire_ship_seg and sup,
        wire_ship_seg_inter=(cfg.data.wire_ship_seg_inter and sup
                             and bool(cfg.train.seg_inter_loss)),
    )


def _overflow(what: str, n: int, cap: int) -> WireOverflowError:
    return WireOverflowError(
        f"{what}: {n} nonzero points exceed the wire cap {cap}; raise "
        "data.wire_radar_cap/wire_gt_cap or set data.wire_format=off")


def _sparsify(idx: np.ndarray, cap: int, what: str) -> np.ndarray:
    if len(idx) > cap:
        raise _overflow(what, len(idx), cap)
    out = np.zeros((cap,), np.int32)
    out[: len(idx)] = idx
    return out


def _pix_view(s: np.ndarray):
    """(view, element stride) where flat pixel ``i`` of a 2-D view lies at
    ``data + i * stride`` (rows back to back: a whole array, or one channel
    of one, as ``radar[..., 0]``); None for any other layout."""
    if s.ndim != 2:
        return None
    it = s.dtype.itemsize
    st_r, st_c = s.strides
    if st_c <= 0 or st_c % it or st_r != s.shape[1] * st_c:
        return None
    return s, st_c // it


def _encode_frame_wire_native(arrays, descs, cfg: DataConfig,
                              plan: WirePlan, h: int, w: int):
    """:func:`encode_frame_wire` through the C++ host code
    (``camradepth_tpu/data/wire.py:222-312``): the union mask and its
    gathers, the inverse-depth encode and sparsify, and the seg resizes,
    each one pass outside the interpreter lock. Returns None for a frame
    that it does not cover, which the numpy path then encodes (and where
    a label lies outside uint8, refuses with its message)."""
    views = []
    for s, _ in descs:
        pv = _pix_view(s)
        if pv is None:
            return None
        views.append(pv)
    dts = {v.dtype for v, _ in views}
    if dts not in ({np.dtype(np.float32)}, {np.dtype(np.float64)}):
        return None
    gt = arrays["gt"]
    g_pv = _pix_view(gt[..., 0]) if (
        gt.ndim == 3 and gt.shape[:2] == (h, w)
        and gt.dtype in (np.float32, np.float64)) else None
    if g_pv is None:
        return None
    mseg = arrays["mseg"]
    if (mseg.dtype not in (np.int64, np.int32) or mseg.ndim != 2
            or not mseg.flags.c_contiguous):
        return None

    npix = h * w
    radar_idx = np.zeros((plan.radar_cap,), np.int32)
    n_pts = native.wire_union_nonzero(views, npix, radar_idx)
    if n_pts > plan.radar_cap:
        raise _overflow("radar channels", n_pts, plan.radar_cap)
    radar_val = np.zeros((plan.radar_cap, plan.n_radar_ch), np.float32)
    for c, ((v, stride), (_, desc)) in enumerate(zip(views, descs)):
        lo, hi, div = desc if desc is not None else (0.0, 0.0, 1.0)
        native.wire_gather(v, stride, radar_idx, n_pts, desc is not None,
                           lo, hi, div, radar_val, c, plan.n_radar_ch)
    out = {"image_u8": np.ascontiguousarray(arrays["image"]),
           "radar_idx": radar_idx, "radar_val": radar_val}

    g, g_stride = g_pv
    if plan.gt_cap:
        gt_idx = np.zeros((plan.gt_cap,), np.int32)
        gt_val = np.zeros((plan.gt_cap,), np.float32)
        n_gt = native.wire_gt_sparse(g, g_stride, npix, float(cfg.max_depth),
                                     gt_idx, gt_val)
        if n_gt > plan.gt_cap:
            raise _overflow("lidar GT", n_gt, plan.gt_cap)
        out["gt_idx"] = gt_idx
        out["gt_val"] = gt_val
    else:
        out["gt_depth"] = native.encode_inverse_depth_native(
            np.ascontiguousarray(g), float(cfg.max_depth))

    mseg = mseg[:h, :]
    for key, ship, shape in (("seg", plan.ship_seg, (h, w)),
                             ("seg_inter", plan.ship_seg_inter,
                              (h // 2, w // 2))):
        if ship:
            seg = native.gather_resize_u8(mseg, *ch._order0_indices(
                mseg.shape[0], mseg.shape[1], shape))
            if seg is None:
                return None
            out[key] = seg
    return out


def encode_frame_wire(arrays: Dict[str, np.ndarray], cfg: DataConfig,
                      plan: WirePlan) -> Dict[str, np.ndarray]:
    """Raw artifact arrays -> one wire example, on the host
    (``camradepth_tpu/data/wire.py:327-405``): through the C++ host code
    with ``cfg.native_assemble``, else (or for a frame that it does not
    cover) in numpy, where each transform runs in the source dtype and is
    then cast to f32, as the dense path does."""
    h, w = cfg.image_dimension
    img = arrays["image"]
    if img.dtype != np.uint8 or img.shape != (h, w, 3):
        raise ValueError(
            f"the wire codec needs the resized uint8 BGR image; got "
            f"{img.dtype} {img.shape} vs {(h, w, 3)}")
    descs = [(np.asarray(s), d) for s, d in _radar_source_descs(arrays,
                                                                cfg)]
    for s, _ in descs:
        if s.shape[:2] != (h, w):
            raise ValueError(f"radar source shape {s.shape} != image "
                             f"dimension {(h, w)}")
    if cfg.native_assemble:
        out = _encode_frame_wire_native(arrays, descs, cfg, plan, h, w)
        if out is not None:
            native.count("wire_native")
            return out
    native.count("wire_numpy")
    mask = np.zeros((h, w), bool)
    for s, _ in descs:
        mask |= s != 0
    pts = np.flatnonzero(mask.reshape(-1))
    radar_idx = _sparsify(pts, plan.radar_cap, "radar channels")
    radar_val = np.zeros((plan.radar_cap, plan.n_radar_ch), np.float32)
    for c, (src, desc) in enumerate(descs):
        vals = _transform(desc)(src.reshape(-1)[pts])
        radar_val[: len(pts), c] = np.asarray(vals, np.float32)
    out = {"image_u8": np.ascontiguousarray(img), "radar_idx": radar_idx,
           "radar_val": radar_val}

    enc = ch.encode_inverse_depth(np.asarray(arrays["gt"][..., 0]),
                                  cfg.max_depth)
    if plan.gt_cap:
        gpts = np.flatnonzero(enc.reshape(-1))
        out["gt_idx"] = _sparsify(gpts, plan.gt_cap, "lidar GT")
        gv = np.zeros((plan.gt_cap,), np.float32)
        gv[: len(gpts)] = enc.reshape(-1)[gpts]
        out["gt_val"] = gv
    else:
        out["gt_depth"] = enc

    mseg = arrays["mseg"][:h, :]
    if plan.ship_seg or plan.ship_seg_inter:
        seg = ch.resize_order0(mseg, (h, w))
        if seg.min() < 0 or seg.max() > 255:
            raise ValueError(
                f"seg labels outside the uint8 range [{seg.min()}, "
                f"{seg.max()}]: the wire codec expects the 21-class + "
                "255-ignore label space")
        if plan.ship_seg:
            out["seg"] = seg.astype(np.uint8)
        if plan.ship_seg_inter:
            out["seg_inter"] = ch.resize_order0(
                mseg, (h // 2, w // 2)).astype(np.uint8)
    return out


def is_wire_micro(micro: Dict) -> bool:
    return "image_u8" in micro


_NORM_LUT: Optional[np.ndarray] = None
_LUTS: Dict[torch.device, torch.Tensor] = {}


def _normalize_lut() -> np.ndarray:
    """[256, 3] f32 table of the host normalization of every byte value,
    in numpy's f32 arithmetic (``(v / 255 - mean) / std``, as
    ``channels.normalize_image``): the device gathers it, so every decoded
    value is the dense path's."""
    global _NORM_LUT
    if _NORM_LUT is None:
        v = np.arange(256, dtype=np.float32)[:, None] / 255.0
        mean = np.asarray(IMAGENET_MEAN, np.float32)
        std = np.asarray(IMAGENET_STD, np.float32)
        _NORM_LUT = ((v - mean) / std).astype(np.float32)
    return _NORM_LUT


def _lut_on(device: torch.device) -> torch.Tensor:
    if device not in _LUTS:
        _LUTS[device] = torch.from_numpy(_normalize_lut()).to(device)
    return _LUTS[device]


def _scatter(idx: torch.Tensor, val: torch.Tensor, npix: int
             ) -> torch.Tensor:
    """[B, P] pixel indices and [B, P, C] f32 values -> [B, npix, C],
    the values added into zeros.

    ``index_add_`` adds with atomics on CUDA, in no fixed order. The sum
    is exact all the same: the encoder lists every real pixel once, and
    its padding rows (index 0, value 0) add +0.0, which leaves any value
    as it is (a -0.0 at pixel 0 becomes the +0.0 that the JAX decode
    also gives)."""
    b, p, c = val.shape
    flat = idx.long() + torch.arange(b, device=idx.device)[:, None] * npix
    out = torch.zeros((b * npix, c), dtype=torch.float32, device=val.device)
    out.index_add_(0, flat.reshape(-1), val.reshape(b * p, c))
    return out.reshape(b, npix, c)


def decode_wire_micro(micro: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """Wire microbatch [B, ...] -> the dense batch (``features`` f32
    [B, H, W, 3 + R], ``gt_depth`` f32 [B, H, W], ``seg``/``seg_inter``
    int32), on the device of its tensors (``camradepth_tpu/data/
    wire.py:431-473``). The image stays f32 from the table; ``radar_val``
    may come in bf16 (a bf16 transfer) and is widened exactly. Keys
    that are not wire keys pass through."""
    u8 = micro["image_u8"]
    b, h, w, _ = u8.shape
    lut = _lut_on(u8.device)
    img = lut[u8.long(), torch.arange(3, device=u8.device)]
    radar = _scatter(micro["radar_idx"], micro["radar_val"].float(), h * w)
    features = torch.cat([img, radar.reshape(b, h, w, -1)], dim=-1)
    out = {k: v for k, v in micro.items() if k not in WIRE_KEYS}
    out["features"] = features
    if "gt_val" in micro:
        gt = _scatter(micro["gt_idx"], micro["gt_val"].float()[..., None],
                      h * w)
        out["gt_depth"] = gt.reshape(b, h, w)
    for key in ("seg", "seg_inter"):
        if key in micro and micro[key].dtype == torch.uint8:
            out[key] = micro[key].to(torch.int32)
    return out
