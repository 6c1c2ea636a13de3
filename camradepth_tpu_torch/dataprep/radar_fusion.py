"""Radar sweep fusion: multi-sweep merge -> projected sparse depth maps.

Counterpart of ``camradepth_tpu/dataprep/radar_fusion.py``, the re-design
of the reference's lib/fuse_radar.py (component #11) and its consumers
scripts/cal_radar.py (#21) and scripts/show_v_comp.py (#22). Host code
walks the nuScenes records and does the per-point math (SE(3) transforms,
Doppler compensation, projection, field-of-view masks) in float64 numpy;
the z-buffer raster is ``geometry/raster.rasterize_radar`` on ``device``,
in float32 as the JAX package rasterizes (its float64 arrays become
float32 in ``jnp.asarray``), and its maps come back to the host for the
flow-to-uv map.

The ``nusc`` argument is duck-typed: any object with the devkit's
``sample``/``get``/``dataroot`` surface works (the tests use a synthetic
world; a real run uses nuscenes.NuScenes).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from camradepth_tpu_torch import resolve_device
from camradepth_tpu_torch.geometry import se3
from camradepth_tpu_torch.geometry.raster import rasterize_radar

# nuScenes radar point rows (devkit RadarPointCloud layout): x,y,z at 0..2,
# RCS at 5, compensated velocity at 8..9.
_ROW_RCS = 5
_ROW_VX, _ROW_VY = 8, 9


def _cam_from_global(nusc, cam_data) -> np.ndarray:
    pose = nusc.get("ego_pose", cam_data["ego_pose_token"])
    cs = nusc.get("calibrated_sensor", cam_data["calibrated_sensor_token"])
    ref_from_car = se3.transform_matrix(cs["translation"], cs["rotation"],
                                        inverse=True)
    car_from_global = se3.transform_matrix(pose["translation"],
                                           pose["rotation"], inverse=True)
    return ref_from_car @ car_from_global


def _sensor_to_global(nusc, sd_rec) -> np.ndarray:
    pose = nusc.get("ego_pose", sd_rec["ego_pose_token"])
    cs = nusc.get("calibrated_sensor", sd_rec["calibrated_sensor_token"])
    global_from_car = se3.transform_matrix(pose["translation"],
                                           pose["rotation"], inverse=False)
    car_from_current = se3.transform_matrix(cs["translation"],
                                            cs["rotation"], inverse=False)
    return global_from_car @ car_from_current


def _load_radar_points(nusc, sd_rec) -> np.ndarray:
    """[rows, N] radar points; devkit filters disabled (reference
    RadarPointCloud.disable_filters, fuse_radar.py:86)."""
    path = Path(nusc.dataroot) / sd_rec["filename"]
    loader = getattr(nusc, "load_radar_points", None)
    if loader is not None:  # fake/test adapter fast path
        return loader(sd_rec)
    from nuscenes.utils.data_classes import RadarPointCloud  # pragma: no cover

    RadarPointCloud.disable_filters()
    return RadarPointCloud.from_file(str(path)).points


def merge_radar_sweeps(
    nusc,
    sample_idx: int,
    frame_range: Tuple[int, int] = (0, 12),
    min_distance: float = 1.0,
) -> Optional[Dict[str, np.ndarray]]:
    """Aggregate radar sweeps into the two consecutive camera frames after
    the key CAM_FRONT frame (reference merge_selected_radar,
    fuse_radar.py:15-153).

    Per sweep: Doppler-compensate x/y by the time lag to each reference
    camera timestamp, rigid-transform into each camera frame, project, and
    apply the joint FOV mask.

    Returns dict of flat [N] arrays (x1,y1,depth1,t1,x2,y2,depth2,t2,
    rcs,v_comp) or None if no sweeps exist in range.
    """
    sample = nusc.sample[sample_idx]
    radar_rec = nusc.get("sample_data", sample["data"]["RADAR_FRONT"])
    # the reference advances one sweep so the newest frame is 'next'
    # (fuse_radar.py:81-82)
    if radar_rec["next"] == "":
        return None
    radar_rec = nusc.get("sample_data", radar_rec["next"])

    cam_data = nusc.get("sample_data", sample["data"]["CAM_FRONT"])
    cam1 = nusc.get("sample_data", cam_data["next"])
    cam2 = nusc.get("sample_data", cam1["next"])
    m_cam1 = _cam_from_global(nusc, cam1)
    m_cam2 = _cam_from_global(nusc, cam2)
    t_ref1 = 1e-6 * cam1["timestamp"]
    t_ref2 = 1e-6 * cam2["timestamp"]
    k1 = np.array(
        nusc.get("calibrated_sensor", cam1["calibrated_sensor_token"])[
            "camera_intrinsic"
        ]
    )
    k2 = np.array(
        nusc.get("calibrated_sensor", cam2["calibrated_sensor_token"])[
            "camera_intrinsic"
        ]
    )

    # rewind to the start of the range
    rec = radar_rec
    for _ in range(frame_range[0]):
        if rec["prev"] == "":
            return None
        rec = nusc.get("sample_data", rec["prev"])

    per_cam = {1: [], 2: []}
    times = {1: [], 2: []}
    extras = []
    nsweeps = frame_range[1] - frame_range[0] + 1
    for _ in range(nsweeps):
        pts = _load_radar_points(nusc, rec)
        keep = np.linalg.norm(pts[:2], axis=0) >= min_distance
        pts = pts[:, keep]
        xyz = pts[:3].T.astype(np.float64)
        vx, vy = pts[_ROW_VX], pts[_ROW_VY]
        m_global = _sensor_to_global(nusc, rec)
        for cam_id, (m_cam, t_ref) in ((1, (m_cam1, t_ref1)),
                                       (2, (m_cam2, t_ref2))):
            lag = t_ref - 1e-6 * rec["timestamp"]
            moved = se3.doppler_compensate(xyz, vx, vy, lag)
            cam_pts = se3.apply_se3(m_cam @ m_global, moved)
            per_cam[cam_id].append(cam_pts)
            times[cam_id].append(np.full(len(cam_pts), abs(lag)))
        extras.append(
            np.stack([pts[_ROW_RCS], np.hypot(vx, vy)], axis=0)
        )
        if rec["prev"] == "":
            break
        rec = nusc.get("sample_data", rec["prev"])

    pc1 = np.concatenate(per_cam[1], axis=0)
    pc2 = np.concatenate(per_cam[2], axis=0)
    t1 = np.concatenate(times[1])
    t2 = np.concatenate(times[2])
    rcs, v_comp = np.concatenate(extras, axis=1)

    x1, y1 = se3.project_pinhole(pc1, k1)
    x2, y2 = se3.project_pinhole(pc2, k2)
    m1 = se3.fov_mask(x1, y1, pc1[:, 2])
    m2 = se3.fov_mask(x2, y2, pc2[:, 2])
    msk = m1 & m2
    return {
        "x1": x1, "y1": y1, "depth1": pc1[:, 2], "t1": t1,
        "x2": x2, "y2": y2, "depth2": pc2[:, 2], "t2": t2,
        "rcs": rcs, "v_comp": v_comp, "valid": msk,
    }


def radar_artifacts(
    nusc,
    sample_idx: int,
    K: np.ndarray,
    frame_range: Tuple[int, int] = (0, 4),
    downsample_scale: float = 2.0,
    y_cutoff: int = 34,
    device="cuda",
) -> Optional[Dict[str, np.ndarray]]:
    """Produce the per-frame radar artifacts:
      radar: [H, W, 3] (depth, u, v)   — cal_radar.py:60-67
      rad_vel: [H, W] binary moving mask — show_v_comp.py / fuse_radar.py:202
    The raster runs on ``device``."""
    dev = resolve_device(device)
    merged = merge_radar_sweeps(nusc, sample_idx, frame_range)
    if merged is None:
        return None

    def on_device(key):
        a = merged[key]
        dtype = torch.bool if a.dtype == bool else torch.float32
        return torch.as_tensor(a, dtype=dtype, device=dev)

    maps = rasterize_radar(
        *(on_device(k) for k in ("x1", "y1", "depth1", "t1", "x2", "y2",
                                 "rcs", "v_comp", "valid")),
        downsample_scale=downsample_scale,
        y_cutoff=y_cutoff,
    )
    depth = maps["depth"].cpu().numpy()
    flow = maps["flow"].cpu().numpy()
    uv = se3.flow_to_uv(
        flow.astype(np.float32), K, depth_mask=depth,
        downsample_scale=downsample_scale, y_cutoff=y_cutoff,
    )
    radar = np.concatenate([depth[..., None], uv], axis=-1).astype(np.float32)
    return {"radar": radar, "rad_vel": maps["v_comp"].cpu().numpy()}
