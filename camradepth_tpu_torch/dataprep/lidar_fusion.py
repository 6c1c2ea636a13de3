"""Accumulated-LiDAR ground-truth fusion.

Counterpart of ``camradepth_tpu/dataprep/lidar_fusion.py``, the re-design
of the reference's lib/fuse_lidar.py (component #12) and
scripts/cal_gt.py (#20): accumulates <=42 forward + 9/21 backward LiDAR
sweeps (skip 1) into the two reference camera frames; rigid scene points
ride the ego pose, in-box points are re-posed through interpolated object
box tracks; occlusion is filtered by (a) vehicle bbox-corner depth vs the
vehicle seg mask and (b) lidar-flow vs image-flow disagreement (> 3 px).

All of it is host code, as in the JAX package: the irregular track
walking and the per-point transforms in float64 numpy
(``geometry/se3.py``), the min-depth raster in the native C++ scatter
(``native.py``, which raises where g++ cannot build it), and the
reference's per-pixel occlusion loops (fuse_lidar.py:656-672) as
vectorized rectangle updates.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from camradepth_tpu_torch import native
from camradepth_tpu_torch.geometry import se3

_BOX_KEYS = ("translation", "size", "rotation", "instance_token",
             "category_name")


# ---------------------------------------------------------------------------
# Box tracks (reference get_tracks_forward / get_tracks_scene,
# fuse_lidar.py:355-443, cal_gt.py:21-55)
# ---------------------------------------------------------------------------

def tracks_forward(nusc, sample_idx: int) -> Tuple[Dict, Dict]:
    """Box poses for the key pair (sample, sample+1) plus interpolated poses
    for every intermediate lidar sweep and the 2nd/3rd camera frames."""
    sample = nusc.sample[sample_idx]
    sample_next = nusc.sample[sample_idx + 1]
    key_tracks: Dict[str, Dict] = {}
    non_tracks: Dict[str, Dict] = {}

    sd = sample["data"]["LIDAR_TOP"]
    sd_next = sample_next["data"]["LIDAR_TOP"]
    key_tracks[sd] = {}
    key_tracks[sd_next] = {}

    tok = sd
    while True:
        tok = nusc.get("sample_data", tok)["next"]
        if tok == sd_next or tok == "":
            break
        non_tracks[tok] = {}
    cam = nusc.get("sample_data", sample["data"]["CAM_FRONT"])
    cam2 = nusc.get("sample_data", cam["next"])
    non_tracks[cam["next"]] = {}
    non_tracks[cam2["next"]] = {}

    for ann_token in sample["anns"]:
        ann = nusc.get("sample_annotation", ann_token)
        if not ann["next"]:
            continue
        ann_next = nusc.get("sample_annotation", ann["next"])
        inst = ann["instance_token"]
        pose = {k: ann[k] for k in _BOX_KEYS}
        pose_next = {k: ann_next[k] for k in _BOX_KEYS}
        t1 = np.asarray(ann["translation"])
        t2 = np.asarray(ann_next["translation"])
        moving = float(np.hypot(*(t1[:2] - t2[:2]))) > 0.2
        pose["is_moving"] = pose_next["is_moving"] = moving
        key_tracks[sd][inst] = pose
        key_tracks[sd_next][inst] = pose_next

    t0 = nusc.get("sample_data", sd)["timestamp"]
    t1 = nusc.get("sample_data", sd_next)["timestamp"]
    for inst, box in key_tracks[sd].items():
        box_next = key_tracks[sd_next][inst]
        d_trans = np.asarray(box_next["translation"]) - np.asarray(
            box["translation"]
        )
        for tok in non_tracks:
            t_sd = nusc.get("sample_data", tok)["timestamp"]
            alpha = (t_sd - t0) / (t1 - t0)
            non_tracks[tok][inst] = {
                "translation": list(
                    np.asarray(box["translation"]) + alpha * d_trans
                ),
                "size": box["size"],
                "rotation": list(
                    se3.quat_slerp(box["rotation"], box_next["rotation"],
                                   alpha)
                ),
                "instance_token": inst,
                "category_name": box["category_name"],
                "is_moving": box["is_moving"],
            }
    return key_tracks, non_tracks


def tracks_for_scene(nusc, sample_idx: int) -> Dict[str, Dict]:
    """All box tracks across the scene containing sample_idx
    (cal_gt.get_tracks_scene)."""
    key_all: Dict[str, Dict] = {}
    non_all: Dict[str, Dict] = {}

    def absorb(idx):
        key, non = tracks_forward(nusc, idx)
        for tok, boxes in key.items():
            key_all.setdefault(tok, {}).update(boxes)
        non_all.update(non)

    idx = sample_idx
    if nusc.sample[idx]["next"] != "":
        absorb(idx)
        while nusc.sample[idx + 1]["next"] != "":
            idx += 1
            absorb(idx)
    idx = sample_idx
    while nusc.sample[idx]["prev"] != "":
        idx -= 1
        absorb(idx)
    key_all.update(non_all)
    return key_all


# ---------------------------------------------------------------------------
# Point accumulation
# ---------------------------------------------------------------------------

def _load_lidar_points(nusc, sd_rec) -> np.ndarray:
    loader = getattr(nusc, "load_lidar_points", None)
    if loader is not None:
        return loader(sd_rec)
    from nuscenes.utils.data_classes import LidarPointCloud  # pragma: no cover

    path = Path(nusc.dataroot) / sd_rec["filename"]
    return LidarPointCloud.from_file(str(path)).points


def _frame_to_ref_global(nusc, sd_token: str, ref_token: str,
                         box_tracks: Dict) -> Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]:
    """One lidar frame -> global coords at the reference frame's time.

    Returns (points [N,3], low_height_mask [N], in_vehicle_box_mask [N]).
    Scene-static points ride the ego pose; points inside any tracked box are
    re-posed via the box's pose at the reference time
    (fuse_lidar.py:84-160)."""
    sd_rec = nusc.get("sample_data", sd_token)
    pts = _load_lidar_points(nusc, sd_rec)
    keep = np.linalg.norm(pts[:2], axis=0) >= 2.5
    xyz = pts[:3, keep].T.astype(np.float64)

    pose = nusc.get("ego_pose", sd_rec["ego_pose_token"])
    cs = nusc.get("calibrated_sensor", sd_rec["calibrated_sensor_token"])
    car_from_cur = se3.transform_matrix(cs["translation"], cs["rotation"])
    global_from_car = se3.transform_matrix(pose["translation"],
                                           pose["rotation"])
    in_car = se3.apply_se3(car_from_cur, xyz)
    low_h = (in_car[:, 2] >= 0.3) & (in_car[:, 2] <= 2.0)
    pts_g = se3.apply_se3(global_from_car @ car_from_cur, xyz)

    in_box = np.zeros(len(pts_g))
    ref_boxes = box_tracks.get(ref_token, {})
    cur_boxes = box_tracks.get(sd_token, {})
    free = np.ones(len(pts_g), bool)
    moved = pts_g.copy()
    for inst, ref_box in ref_boxes.items():
        if inst not in cur_boxes:
            continue
        box = cur_boxes[inst]
        to_obj = se3.transform_matrix(box["translation"], box["rotation"],
                                      inverse=True)
        in_obj = se3.apply_se3(to_obj, pts_g)
        w, l, h = box["size"]
        inside = (
            (np.abs(in_obj[:, 0]) < l / 2)
            & (np.abs(in_obj[:, 1]) < w / 2)
            & (np.abs(in_obj[:, 2]) < h / 2)
            & free
        )
        if not inside.any():
            continue
        ref_pose = ref_boxes[inst]
        obj_to_global_ref = se3.transform_matrix(
            ref_pose["translation"], ref_pose["rotation"]
        )
        moved[inside] = se3.apply_se3(obj_to_global_ref, in_obj[inside])
        if "vehicle" in box["category_name"]:
            in_box[inside] = 1.0
        free &= ~inside
    return moved, low_h, in_box


def merge_lidar(
    nusc,
    sample_idx: int,
    n_backward: int,
    n_forward: int,
    box_tracks: Dict,
    n_skip: int = 1,
) -> Dict[str, np.ndarray]:
    """Accumulate sweeps around the key frame into both reference cameras
    (fuse_lidar.merge_lidar, :34-277). Returns flat point arrays plus the
    projected vehicle-box corner cloud used by the bbox occlusion filter."""
    sample = nusc.sample[sample_idx]
    ref_sd = sample["data"]["LIDAR_TOP"]
    cam = nusc.get("sample_data", sample["data"]["CAM_FRONT"])
    cam1_tok = cam["next"]
    cam1 = nusc.get("sample_data", cam1_tok)
    cam2_tok = cam1["next"]
    cam2 = nusc.get("sample_data", cam2_tok)

    def cam_from_global(c):
        pose = nusc.get("ego_pose", c["ego_pose_token"])
        cs = nusc.get("calibrated_sensor", c["calibrated_sensor_token"])
        return se3.transform_matrix(cs["translation"], cs["rotation"],
                                    True) @ se3.transform_matrix(
            pose["translation"], pose["rotation"], True
        )

    m_cam1 = cam_from_global(cam1)
    m_cam2 = cam_from_global(cam2)
    k1 = np.array(
        nusc.get("calibrated_sensor", cam1["calibrated_sensor_token"])[
            "camera_intrinsic"
        ]
    )

    pcs1: List[np.ndarray] = []
    pcs2: List[np.ndarray] = []
    low_hs: List[np.ndarray] = []
    in_boxes: List[np.ndarray] = []

    def absorb(tok):
        p1, lh, ib = _frame_to_ref_global(nusc, tok, cam1_tok, box_tracks)
        p2, _, _ = _frame_to_ref_global(nusc, tok, cam2_tok, box_tracks)
        pcs1.append(se3.apply_se3(m_cam1, p1))
        pcs2.append(se3.apply_se3(m_cam2, p2))
        low_hs.append(lh)
        in_boxes.append(ib)

    # forward walk (incl the key frame)
    tok, ct = ref_sd, 0
    while ct <= n_forward and tok != "":
        absorb(tok)
        for _ in range(n_skip + 1):
            tok = nusc.get("sample_data", tok)["next"]
            ct += 1
            if tok == "":
                break
    # backward walk
    tok, ct = ref_sd, 0
    for _ in range(n_skip + 1):
        tok = nusc.get("sample_data", tok)["prev"]
        ct += 1
        if tok == "":
            break
    while ct <= n_backward and tok != "":
        absorb(tok)
        for _ in range(n_skip + 1):
            tok = nusc.get("sample_data", tok)["prev"]
            ct += 1
            if tok == "":
                break

    pc1 = np.concatenate(pcs1, axis=0)
    pc2 = np.concatenate(pcs2, axis=0)
    low_h = np.concatenate(low_hs)
    in_box = np.concatenate(in_boxes)

    x1, y1 = se3.project_pinhole(pc1, k1)
    x2, y2 = se3.project_pinhole(pc2, k1)
    msk = se3.fov_mask(x1, y1, pc1[:, 2]) & se3.fov_mask(x2, y2, pc2[:, 2])

    # vehicle box corners at the cam1-ref pose... projected with cam1
    # intrinsics but transformed into the CAM2 frame — the reference does
    # exactly this (fuse_lidar.py:206-207 vs :269); preserved.
    corners = []
    for inst, box in box_tracks.get(cam1_tok, {}).items():
        if "vehicle" not in box["category_name"]:
            continue
        w, l, h = box["size"]
        grid = np.array(
            [[xc, yc, zc] for xc in (-l / 2, l / 2)
             for yc in (-w / 2, w / 2) for zc in (-h / 2, h / 2)]
        )
        to_global = se3.transform_matrix(box["translation"], box["rotation"])
        corners.append(se3.apply_se3(to_global, grid))
    if corners:
        cn = se3.apply_se3(m_cam2, np.concatenate(corners, axis=0))
        x_cn, y_cn = se3.project_pinhole(cn, k1)
        msk_cn = se3.fov_mask(x_cn, y_cn, cn[:, 2])
        depth_cn = cn[:, 2]
    else:
        x_cn = y_cn = depth_cn = np.zeros(0)
        msk_cn = np.zeros(0, bool)

    return {
        "x1": x1[msk], "y1": y1[msk], "depth1": pc1[msk, 2],
        "x2": x2[msk], "y2": y2[msk], "depth2": pc2[msk, 2],
        "low_h": low_h[msk], "in_box": in_box[msk],
        "x_cn": x_cn, "y_cn": y_cn, "depth_cn": depth_cn, "msk_cn": msk_cn,
    }


# ---------------------------------------------------------------------------
# Rasterization + occlusion filtering (cal_gt.py:123-138)
# ---------------------------------------------------------------------------

def lidar_maps(points: Dict[str, np.ndarray], downsample_scale: float = 2.0,
               y_cutoff: int = 34, h_im: int = 900, w_im: int = 1600
               ) -> Dict[str, np.ndarray]:
    """Min-depth raster of the accumulated cloud with flow / low-height /
    in-box payloads (fuse_lidar.cal_depthMap_flow, :281-323), in the
    native C++ scatter on the host (``native.py``)."""
    h_out = int(h_im / downsample_scale)
    w_out = int(w_im / downsample_scale)
    pix, xq1, yq1 = native.quantize_pixels_host(
        points["x1"], points["y1"], None, downsample_scale, h_out, w_out
    )
    _, xq2, yq2 = native.quantize_pixels_host(
        points["x2"], points["y2"], None, downsample_scale, h_out, w_out
    )
    payload = {
        "flow": np.stack([xq2 - xq1, yq2 - yq1], axis=-1),
        "low_h": points["low_h"].astype(np.float64),
        "in_box": points["in_box"].astype(np.float64),
    }
    depth_map, maps = native.raster_min_depth_host(
        pix, points["depth1"], payload, h_out * w_out
    )

    def grid(a):
        a = np.asarray(a)
        return a.reshape((h_out, w_out) + a.shape[1:])[y_cutoff:]

    return {
        "depth": grid(depth_map),
        "flow": grid(maps["flow"]),
        "low_h": grid(maps["low_h"]) > 0,
        "in_box": grid(maps["in_box"]) > 0,
    }


def filter_occlusion_by_bbox(
    depth_map: np.ndarray,
    seg: np.ndarray,
    in_box_map: np.ndarray,
    x_cn: np.ndarray,
    y_cn: np.ndarray,
    depth_cn: np.ndarray,
    msk_cn: np.ndarray,
    downsample_scale: float = 2.0,
    y_cutoff: int = 34,
    h_im: int = 900,
    w_im: int = 1600,
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop points that are behind a vehicle box yet land on vehicle-seg
    pixels (fuse_lidar.filter_occlusion_by_bbox, :634-676) — vectorized
    per-box rectangle update instead of the reference's per-pixel loop."""
    h_new = int(h_im / downsample_scale) - y_cutoff
    w_new = int(w_im / downsample_scale)
    x_cn = (x_cn + 0.5) / downsample_scale - 0.5
    y_cn = (y_cn + 0.5) / downsample_scale - 0.5 - y_cutoff
    depth_map = depth_map.copy()
    seg_b = seg.astype(bool)
    for start in range(0, len(x_cn), 8):
        xs = x_cn[start: start + 8]
        ys = y_cn[start: start + 8]
        ms = msk_cn[start: start + 8]
        ds = depth_cn[start: start + 8]
        # reference keeps only in-FOV corners for the rect but takes d_max
        # over ALL 8 corners (fuse_lidar.py:662-668)
        xs, ys = xs[ms], ys[ms]
        if len(xs) == 0:
            continue
        d_max = ds.max()
        xs = np.clip(xs, 0, w_new - 1)
        ys = np.clip(ys, 0, h_new - 1)
        x0, x1 = int(round(xs.min())), int(round(xs.max()))
        y0, y1 = int(round(ys.min())), int(round(ys.max()))
        window = np.s_[y0: y1 + 1, x0: x1 + 1]
        kill = (
            seg_b[window]
            & (depth_map[window] > 0)
            & (~in_box_map[window])
            & (depth_map[window] > d_max)
        )
        depth_map[window] = np.where(kill, 0.0, depth_map[window])
    return depth_map, depth_map > 0


def filter_occlusion_by_flow(
    depth_map, low_h_map, in_box_map, flow_lidar, flow_im, thres: float = 3.0
):
    """Drop pixels whose accumulated-lidar flow disagrees with the image
    flow by > thres px (fuse_lidar.filter_occlusion, :554-568)."""
    l2 = np.hypot(*(flow_lidar - flow_im).transpose(2, 0, 1))
    occ = (depth_map > 0) & (l2 > thres)
    depth_map = np.where(occ, 0.0, depth_map)
    low_h_map = low_h_map & ~occ
    in_box_map = in_box_map & ~occ
    flow_lidar = np.where(occ[..., None], 0.0, flow_lidar)
    return depth_map, low_h_map, in_box_map, flow_lidar


def gt_artifacts(
    nusc,
    sample_idx: int,
    box_tracks: Dict,
    K: np.ndarray,
    flow_im: np.ndarray,
    seg: np.ndarray,
    downsample_scale: float = 2.0,
    y_cutoff: int = 34,
) -> Dict[str, np.ndarray]:
    """Full GT assembly for one frame (cal_gt.py:100-138):
    returns {"gt": [H,W,3] (depth,u,v), "msk_lh": [H,W] bool}."""
    # sweep counts: near scene end the forward window shrinks so backward
    # grows (cal_gt.py:116-121)
    n_forward, n_skip = 42, 1
    near_end = (
        nusc.sample[sample_idx]["next"] == ""
        or nusc.sample[sample_idx + 1]["next"] == ""
        or nusc.sample[sample_idx + 2]["next"] == ""
    )
    n_backward = 21 if near_end else 9

    pts = merge_lidar(nusc, sample_idx, n_backward, n_forward, box_tracks,
                      n_skip)
    maps = lidar_maps(pts, downsample_scale, y_cutoff)
    depth, msk = filter_occlusion_by_bbox(
        maps["depth"], seg, maps["in_box"],
        pts["x_cn"], pts["y_cn"], pts["depth_cn"], pts["msk_cn"],
        downsample_scale, y_cutoff,
    )
    flow = maps["flow"] * msk[..., None]
    low_h = maps["low_h"] & msk
    depth, low_h, _, flow = filter_occlusion_by_flow(
        depth, low_h, maps["in_box"], flow, flow_im, thres=3.0
    )
    uv = se3.flow_to_uv(
        flow.astype(np.float32), K, depth_mask=depth,
        downsample_scale=downsample_scale, y_cutoff=y_cutoff,
    )
    gt = np.concatenate([depth[..., None], uv], axis=-1).astype(np.float32)
    return {"gt": gt, "msk_lh": low_h}
