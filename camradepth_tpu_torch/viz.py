"""Visualization: per-frame prediction collages.

Counterpart of ``camradepth_tpu/viz.py`` (the reference's
src/visualization/visualization.py): batched inference over a split, and
per frame the panels original image, GT depth scattered on the image,
predicted depth, radar overlay, predicted or GT segmentation and a blended
view, written as one collage. numpy and cv2, as the JAX package's; the
forward is the port's model, or a ``predict`` callable (a serving
artifact, ``cli viz``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from camradepth_tpu_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ExperimentConfig,
)

# 21-class label palette (arbitrary but fixed; label 255 renders black)
_PALETTE = np.array(
    [
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
        [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
        [0, 0, 230], [119, 11, 32], [255, 204, 54], [220, 220, 220],
    ],
    dtype=np.uint8,
)


def denormalize_image(features: np.ndarray) -> np.ndarray:
    """First 3 feature channels back to uint8 BGR (inverse of the loader's
    ImageNet normalization; the BGR order is the loader's quirk)."""
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    img = (features[..., :3] * std + mean) * 255.0
    return np.clip(img, 0, 255).astype(np.uint8)


def colorize_depth(depth_inv: np.ndarray, max_depth: float = 100.0,
                   invalid_black: bool = True) -> np.ndarray:
    """Inverse-encoded depth [0,1] -> turbo-colormapped BGR image."""
    if cv2 is None:  # pragma: no cover
        raise RuntimeError("cv2 required")
    v = np.clip(depth_inv, 0.0, 1.0)
    u8 = (v * 255).astype(np.uint8)
    colored = cv2.applyColorMap(u8, cv2.COLORMAP_TURBO)
    if invalid_black:
        colored[depth_inv <= 0] = 0
    return colored


def colorize_seg(labels: np.ndarray) -> np.ndarray:
    out = np.zeros((*labels.shape, 3), np.uint8)
    valid = labels != 255
    out[valid] = _PALETTE[labels[valid] % len(_PALETTE)][..., ::-1]
    return out


def overlay_sparse(image_bgr: np.ndarray, sparse_inv: np.ndarray,
                   radius: int = 1) -> np.ndarray:
    """Scatter sparse (radar/lidar) inverse-depth points over an image."""
    out = image_bgr.copy()
    colored = colorize_depth(sparse_inv, invalid_black=False)
    mask = sparse_inv > 0
    if radius > 1:
        mask = cv2.dilate(mask.astype(np.uint8), np.ones((radius, radius),
                                                         np.uint8)) > 0
        colored = cv2.dilate(colored, np.ones((radius, radius), np.uint8))
    out[mask] = colored[mask]
    return out


def frame_panels(features: np.ndarray, gt_depth: np.ndarray,
                 pred: Dict[str, np.ndarray],
                 seg_gt: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    img = denormalize_image(features)
    panels = {
        "image": img,
        "gt_depth": overlay_sparse(img, gt_depth, radius=2),
        "pred_depth": colorize_depth(
            np.clip(pred["depth"], 0, 1), invalid_black=False
        ),
        "radar": overlay_sparse(img, features[..., 3], radius=3),
    }
    blend = cv2.addWeighted(img, 0.4, panels["pred_depth"], 0.6, 0)
    panels["blended"] = blend
    if pred.get("seg") is not None:
        panels["pred_seg"] = colorize_seg(pred["seg"])
    elif seg_gt is not None:
        panels["gt_seg"] = colorize_seg(seg_gt)
    return panels


def collage(panels: Dict[str, np.ndarray], cols: int = 3) -> np.ndarray:
    keys = list(panels)
    h, w = panels[keys[0]].shape[:2]
    rows = -(-len(keys) // cols)
    canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, k in enumerate(keys):
        r, c = divmod(i, cols)
        p = panels[k]
        if p.shape[:2] != (h, w):
            p = cv2.resize(p, (w, h))
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = p
        cv2.putText(canvas, k, (c * w + 8, r * h + 24),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.7, (255, 255, 255), 2)
    return canvas


def model_predict(cfg: ExperimentConfig, model, device="cuda"):
    """``predict(features_np) -> (depth_enc [B, H, W] in [0, 1], seg labels
    [B, H, W] or None)`` of the port's ``model`` on ``device``."""
    import torch

    from camradepth_tpu_torch import resolve_device

    dev = resolve_device(device)
    n_in = cfg.model.input_channels

    def predict(feats):
        x = torch.from_numpy(np.ascontiguousarray(feats[..., :n_in]))
        with torch.inference_mode():
            out = model(x.to(dev))
            depth = out["depth"]["final_depth"][..., 0].float().cpu().numpy()
            logits = out["seg"]["final_seg"]
            seg = (None if logits is None
                   else logits.argmax(-1).cpu().numpy())
        return depth, seg

    return predict


def run_visualization(cfg: ExperimentConfig, model, loader,
                      out_dir: str | Path, num_frames: int = 25,
                      predict=None, device="cuda") -> int:
    """Batched inference + per-frame collage dump (reference
    visualization.py:24-182). Returns the number of frames written.

    ``predict(features_np) -> (depth_enc [B,H,W] in [0,1], seg labels
    [B,H,W] or None)`` overrides the model forward (a serving artifact,
    ``cli viz --checkpoint A.pt2``); otherwise ``model`` runs on
    ``device``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if predict is None:
        predict = model_predict(cfg, model, device)

    written = 0
    for batch in loader:
        depth, seg = predict(batch["features"])
        for i in range(depth.shape[0]):
            if not batch["valid"][i]:
                continue
            pred = {"depth": depth[i],
                    "seg": None if seg is None else seg[i]}
            panels = frame_panels(
                batch["features"][i], batch["gt_depth"][i], pred,
                seg_gt=batch.get("seg", [None] * depth.shape[0])[i],
            )
            name = loader.frames.name(int(batch["index"][i]))
            cv2.imwrite(str(out_dir / name), collage(panels))
            written += 1
            if written >= num_frames:
                return written
    return written
