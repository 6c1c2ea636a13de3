"""Per-frame channel assembly: artifact arrays -> model feature stack.

The package's own copy of the numpy path of
``camradepth_tpu/data/channels.py``: the reference dataset's transforms
(dataloader.py:197-333), quirks included:

  feature[..., 0:3]  image: BGR (cv2 order), /255, ImageNet-normalized with
                     RGB-ordered statistics (dataloader.py:225-232)
  feature[..., 3:4]  radar depth clip[0, max]/max (not inverted, unlike GT)
  feature[..., 4:6]  radar uv flow
  feature[..., 6:7]  radar moving-object mask (rad_vel)

  gt depth: clip[0, 100] then inverse-encoded (100 - d)/100 on valid pixels
  (dataloader.py:240-245).

The port always assembles with numpy. The JAX package's C++ assembler
(``native_assemble``, ``camradepth_tpu/native.py``) is bit-exact with this
path and only faster; it is not ported yet (ROADMAP queue 1 item 12), and
``DataConfig.native_assemble`` is ignored here. Layout is NHWC.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

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


def resize_order0(img: np.ndarray, shape: tuple) -> np.ndarray:
    """Order-0 (nearest) resize with skimage's coordinate convention
    (in = (out + 0.5) * in/out - 0.5, rounded half up, clipped), replacing
    skimage's resize(order=0) of the seg GT (dataloader.py:265-268)."""
    h_in, w_in = img.shape[0], img.shape[1]
    h_out, w_out = shape
    rows = (np.arange(h_out) + 0.5) * (h_in / h_out) - 0.5
    cols = (np.arange(w_out) + 0.5) * (w_in / w_out) - 0.5
    ri = np.clip(np.floor(rows + 0.5).astype(np.int64), 0, h_in - 1)
    ci = np.clip(np.floor(cols + 0.5).astype(np.int64), 0, w_in - 1)
    return img[np.ix_(ri, ci)]


def assemble_frame(
    arrays: Dict[str, np.ndarray],
    cfg: DataConfig,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, np.ndarray]:
    """Build one example from raw artifact arrays
    (``camradepth_tpu/data/channels.py:180-243``, numpy path).

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
