"""SE(3)/quaternion math and pinhole projection over point sets.

Counterpart of ``camradepth_tpu/geometry/se3.py``: quaternion rotations,
rigid transforms, Doppler motion compensation, camera projection and the
flow-to-uv map over [N, ...] point sets. The 4x4 transforms are numpy
(float64) host code; the array functions take numpy arrays or torch
tensors, where the JAX package takes numpy or ``jax.numpy`` arrays, and
return the same kind.

Quaternions are plain [w, x, y, z] arrays (no pyquaternion).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def quat_to_rot(q) -> np.ndarray:
    """[w,x,y,z] quaternion -> 3x3 rotation matrix."""
    w, x, y, z = (float(v) for v in q)
    n = (w * w + x * x + y * y + z * z) ** 0.5
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def transform_matrix(translation, rotation_q, inverse: bool = False
                     ) -> np.ndarray:
    """4x4 rigid transform from translation + quaternion (the nuScenes
    devkit convention)."""
    tm = np.eye(4, dtype=np.float64)
    rot = quat_to_rot(rotation_q)
    t = np.asarray(translation, np.float64)
    if not inverse:
        tm[:3, :3] = rot
        tm[:3, 3] = t
    else:
        tm[:3, :3] = rot.T
        tm[:3, 3] = rot.T @ (-t)
    return tm


def quat_slerp(q0, q1, amount: float) -> np.ndarray:
    """Spherical linear interpolation between [w,x,y,z] quaternions
    (pyquaternion ``Quaternion.slerp``)."""
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    dot = float(np.dot(q0, q1))
    if dot < 0.0:
        q1 = -q1
        dot = -dot
    if dot > 0.9995:
        out = q0 + amount * (q1 - q0)
        return out / np.linalg.norm(out)
    theta0 = np.arccos(np.clip(dot, -1.0, 1.0))
    theta = theta0 * amount
    s0 = np.cos(theta) - dot * np.sin(theta) / np.sin(theta0)
    s1 = np.sin(theta) / np.sin(theta0)
    return s0 * q0 + s1 * q1


def compose(*mats) -> np.ndarray:
    out = np.eye(4, dtype=np.float64)
    for m in mats:
        out = out @ m
    return out


def _as(arr, like):
    """``arr`` (a numpy array, a tensor or a scalar) in the kind of
    ``like``: a tensor on its device and in its dtype, or numpy."""
    if torch.is_tensor(like):
        return torch.as_tensor(arr, dtype=like.dtype, device=like.device)
    return np.asarray(arr)


def apply_se3(tm, points):
    """[4,4] x [N,3] -> [N,3], for numpy arrays or tensors."""
    tm = _as(tm, points)
    return points @ tm[:3, :3].T + tm[:3, 3]


def doppler_compensate(points, vx_comp, vy_comp, time_lag):
    """Radar Doppler motion compensation: advance x/y by the compensated
    velocity times the time lag (fuse_radar.py:44-51). points [N,3]."""
    if torch.is_tensor(points):
        delta = torch.stack([vx_comp * time_lag, vy_comp * time_lag,
                             torch.zeros_like(vx_comp)], dim=-1)
    else:
        delta = np.stack([vx_comp * time_lag, vy_comp * time_lag,
                          np.zeros_like(vx_comp)], axis=-1)
    return points + delta


def project_pinhole(points_cam, K) -> Tuple:
    """Camera-frame [N,3] -> pixel (x, y) with z-normalization (devkit
    ``view_points``)."""
    K = _as(K, points_cam)
    z = points_cam[:, 2]
    if torch.is_tensor(points_cam):
        safe_z = torch.where(z != 0, z, torch.ones_like(z))
    else:
        safe_z = np.where(z != 0, z, 1.0)
    x = points_cam[:, 0] * K[0, 0] / safe_z + K[0, 2]
    y = points_cam[:, 1] * K[1, 1] / safe_z + K[1, 2]
    return x, y


def fov_mask(x, y, z, width: int = 1600, height: int = 900,
             min_z: float = 2.0):
    """In-image + min-depth mask (fuse_radar.py:68-74: strict bounds)."""
    return (x > 0) & (x < width) & (y > 0) & (y < height) & (z >= min_z)


def flow_to_uv(flow, K, depth_mask=None, downsample_scale: float = 2,
               y_cutoff: int = 34):
    """Pixel flow -> normalized camera-plane target coords
    (scripts/cal_im_flow2uv.py:11-34, fuse_radar.py:276-303).

    flow: [H, W, 2] (dx, dy). Returns [H, W, 2] uv; with ``depth_mask``
    the uv is zeroed where the mask is empty (the radar variant)."""
    f = K[0, 0] / downsample_scale
    cx = K[0, 2] / downsample_scale
    cy = K[1, 2] / downsample_scale - y_cutoff
    h, w = flow.shape[:2]
    if torch.is_tensor(flow):
        f, cx, cy = (float(v) for v in (f, cx, cy))
        cols = torch.arange(w, dtype=flow.dtype, device=flow.device)
        rows = torch.arange(h, dtype=flow.dtype, device=flow.device)
        stack = lambda a, b: torch.stack([a, b], dim=-1)
    else:
        cols = np.arange(w, dtype=flow.dtype)
        rows = np.arange(h, dtype=flow.dtype)
        stack = lambda a, b: np.stack([a, b], axis=-1)
    x_map = cols[None, :] + flow[..., 0]
    y_map = rows[:, None] + flow[..., 1]
    u = (x_map - cx) / f
    v = (y_map - cy) / f
    if depth_mask is not None:
        m = depth_mask > 0
        u = u * m
        v = v * m
    return stack(u, v)
