"""Per-frame channel assembly: artifact arrays -> model feature stack.

The package's own copy of ``camradepth_tpu/data/channels.py``: the
reference dataset's transforms
(dataloader.py:197-333), quirks included:

  feature[..., 0:3]  image: BGR (cv2 order), /255, ImageNet-normalized with
                     RGB-ordered statistics (dataloader.py:225-232)
  feature[..., 3:4]  radar depth clip[0, max]/max (not inverted, unlike GT)
  feature[..., 4:6]  radar uv flow
  feature[..., 6:7]  radar moving-object mask (rad_vel)

  gt depth: clip[0, 100] then inverse-encoded (100 - d)/100 on valid pixels
  (dataloader.py:240-245).

With ``DataConfig.native_assemble`` (the default) a frame is assembled by
the package's C++ host code (``native.py``, ``csrc/host/rasterize.cc``),
bit for bit with the numpy path and outside the interpreter lock, so the
loader's worker threads run in parallel; ``camradepth_tpu/data/
channels.py:85-201``. A frame that the C++ code does not cover (sparse
lidar, an fp16 or non-contiguous source, a shape other than (H, W)) takes
the numpy path, with the same result; ``native.counts`` counts both.
Layout is NHWC.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from camradepth_tpu_torch import native as nat
from camradepth_tpu_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    DataConfig,
)


def normalize_image(image_u8: np.ndarray) -> np.ndarray:
    """uint8 HWC (BGR, cv2 order) -> float32 normalized (RGB-ordered
    ImageNet statistics applied to BGR channels, as the reference)."""
    x = image_u8.astype(np.float32) / 255.0
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    return (x - mean) / std


def encode_inverse_depth(depth: np.ndarray, max_depth: float = 100.0
                         ) -> np.ndarray:
    """GT depth -> normalized inverse encoding: 0 stays 0 (invalid), valid d
    becomes (max - clip(d)) / max (dataloader.py:240-245)."""
    d = np.clip(depth, 0, max_depth)
    out = np.where(d > 0, (max_depth - d) / max_depth, 0.0)
    return out.astype(np.float32)


def decode_inverse_depth(encoded: np.ndarray, max_depth: float = 100.0
                         ) -> np.ndarray:
    """Inverse of :func:`encode_inverse_depth` on valid pixels."""
    return np.where(encoded > 0, max_depth - encoded * max_depth, 0.0)


def _order0_indices(h_in: int, w_in: int, shape: tuple):
    """Row and column gather indices of the order-0 resize (skimage's
    convention: in = (out + 0.5) * in/out - 0.5, rounded half up,
    clipped)."""
    h_out, w_out = shape
    rows = (np.arange(h_out) + 0.5) * (h_in / h_out) - 0.5
    cols = (np.arange(w_out) + 0.5) * (w_in / w_out) - 0.5
    ri = np.clip(np.floor(rows + 0.5).astype(np.int64), 0, h_in - 1)
    ci = np.clip(np.floor(cols + 0.5).astype(np.int64), 0, w_in - 1)
    return ri, ci


def resize_order0(img: np.ndarray, shape: tuple) -> np.ndarray:
    """Order-0 (nearest) resize with skimage's coordinate convention,
    replacing skimage's resize(order=0) of the seg GT
    (dataloader.py:265-268)."""
    ri, ci = _order0_indices(img.shape[0], img.shape[1], shape)
    return img[np.ix_(ri, ci)]


_MEAN_F32 = np.asarray(IMAGENET_MEAN, np.float32)
_STD_F32 = np.asarray(IMAGENET_STD, np.float32)


def _assemble_frame_native(arrays: Dict[str, np.ndarray], cfg: DataConfig
                           ) -> Optional[Dict[str, np.ndarray]]:
    """:func:`assemble_frame` through the C++ host code
    (``camradepth_tpu/data/channels.py:85-177``): each channel group is
    written straight into the preallocated interleaved float32 buffer in
    one pass outside the interpreter lock. Returns None for a frame that
    it does not cover, which the numpy path then assembles."""
    if cfg.sparse_lidar:  # random masks: numpy only
        return None
    h, w = cfg.image_dimension
    npix = h * w
    img = arrays["image"]
    gt = arrays["gt"]
    if (img.dtype != np.uint8 or img.shape != (h, w, 3)
            or not img.flags.c_contiguous):
        return None
    if gt.shape[:2] != (h, w):
        return None

    def f2d(a):
        """[npix, k] contiguous float32/float64 view, or None."""
        if a.dtype not in (np.float32, np.float64):
            return None
        if a.shape[:2] != (h, w) or not a.flags.c_contiguous:
            return None
        return a.reshape(npix, 1 if a.ndim == 2 else a.shape[2])

    # (src2d, ch0, n_ch, use_clip, lo, hi, div) per feature group, in the
    # numpy path's channel order; a no-clip group with div 1.0 is a cast
    # (x / 1.0 is exact)
    plan = []
    if cfg.filtered_radar:
        src = f2d(arrays["radar_filtered"])
        if src is None:
            return None
        # the reference hard-codes 100.0 here, not max_depth
        plan.append((src, 0, 1, True, 0.0, 100.0, 100.0))
    else:
        radar = f2d(arrays["radar"])
        if radar is None or radar.shape[1] < 3:
            return None
        plan.append((radar, 0, 1, True, 0.0, cfg.max_depth, cfg.max_depth))
        if cfg.sparse_depth_uv:
            plan.append((radar, 1, 2, False, 0.0, 0.0, 1.0))
        if cfg.rad_vel:
            vel = f2d(arrays["rad_vel"])
            if vel is None:
                return None
            plan.append((vel, 0, 1, False, 0.0, 0.0, 1.0))
        if cfg.im_uv:
            uv = f2d(arrays["im_uv"])
            if uv is None:
                return None
            plan.append((uv, 0, 2, False, 0.0, 0.0, 1.0))
    gtd = np.ascontiguousarray(gt[..., 0])
    if gtd.dtype not in (np.float32, np.float64):
        return None

    feats2d = np.empty((npix, 3 + sum(p[2] for p in plan)), np.float32)
    nat.normalize_image_into(img.reshape(npix, 3), _MEAN_F32, _STD_F32,
                             feats2d, 0)
    col = 3
    for src, ch0, n_ch, use_clip, lo, hi, div in plan:
        nat.scale_clip_into(src, ch0, n_ch, feats2d, col, use_clip, lo, hi,
                            div)
        col += n_ch
    gt_depth = nat.encode_inverse_depth_native(gtd, cfg.max_depth)

    mseg = arrays["mseg"][:h, :]
    if mseg.dtype in (np.int64, np.int32) and mseg.flags.c_contiguous:
        seg, seg_inter = (
            nat.gather_resize_i32(mseg, *_order0_indices(
                mseg.shape[0], mseg.shape[1], shape))
            for shape in ((h, w), (h // 2, w // 2)))
    else:  # a uint8 map, say: its seg resize alone runs in numpy
        seg = resize_order0(mseg, (h, w)).astype(np.int32)
        seg_inter = resize_order0(mseg, (h // 2, w // 2)).astype(np.int32)
    return {"features": feats2d.reshape(h, w, -1), "gt_depth": gt_depth,
            "seg": seg, "seg_inter": seg_inter}


def assemble_frame(
    arrays: Dict[str, np.ndarray],
    cfg: DataConfig,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, np.ndarray]:
    """Build one example from raw artifact arrays
    (``camradepth_tpu/data/channels.py:180-243``): through the C++ host
    code with ``cfg.native_assemble``, else (or for a frame that it does
    not cover) in numpy, with the same result.

    Args:
      arrays: {"image": HxWx3 uint8 BGR (already resized to
               cfg.image_dimension), "radar": HxWx3 (depth, u, v),
               "radar_filtered": HxW, "mseg": H'xW int labels,
               "im_uv": HxWx2, "rad_vel": HxW, "gt": HxWx3 (depth, u, v)}
      cfg: DataConfig with the channel flags.
      rng: numpy Generator for the sparse-lidar mask mode.
    Returns:
      {"features": HxWxC float32, "gt_depth": HxW float32 (inverse-encoded),
       "seg": HxW int32, "seg_inter": H/2xW/2 int32}
    """
    if cfg.native_assemble:
        out = _assemble_frame_native(arrays, cfg)
        if out is not None:
            nat.count("assemble_native")
            return out
    nat.count("assemble_numpy")
    h, w = cfg.image_dimension
    feats = [normalize_image(arrays["image"])]

    gt = arrays["gt"]
    gt_depth_raw = gt[..., 0]
    gt_depth = encode_inverse_depth(gt_depth_raw, cfg.max_depth)

    if cfg.sparse_lidar:
        # randomly sparsified lidar as input (dataloader.py:273-289)
        rng = rng or np.random.default_rng()
        mask = rng.choice([0, 1], size=gt_depth_raw.shape, p=cfg.lidar_ratio)
        sparse = np.clip(gt_depth_raw * mask, 0, 100.0) / 100.0
        feats.append(sparse[..., None].astype(np.float32))
        if cfg.sparse_depth_uv:
            feats.append((gt[..., 1:3] * mask[..., None]).astype(np.float32))
    elif cfg.filtered_radar:
        filt = np.clip(arrays["radar_filtered"], 0, 100.0) / 100.0
        feats.append(filt[..., None].astype(np.float32))
    else:
        radar = arrays["radar"]
        rd = np.clip(radar[..., 0], 0, cfg.max_depth) / cfg.max_depth
        feats.append(rd[..., None].astype(np.float32))
        if cfg.sparse_depth_uv:
            feats.append(radar[..., 1:3].astype(np.float32))
        if cfg.rad_vel:
            feats.append(arrays["rad_vel"][..., None].astype(np.float32))
        if cfg.im_uv:
            feats.append(arrays["im_uv"].astype(np.float32))

    features = np.concatenate(feats, axis=-1)

    mseg = arrays["mseg"][:h, :]
    seg = resize_order0(mseg, (h, w)).astype(np.int32)
    seg_inter = resize_order0(mseg, (h // 2, w // 2)).astype(np.int32)

    return {
        "features": features.astype(np.float32),
        "gt_depth": gt_depth,
        "seg": seg,
        "seg_inter": seg_inter,
    }
