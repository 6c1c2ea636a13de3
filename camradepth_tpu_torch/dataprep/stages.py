"""Offline data-preparation stages (the reference's 11-step pipeline).

Counterpart of ``camradepth_tpu/dataprep/stages.py``. Each stage mirrors
one script of the reference's ``scripts/`` as a function that writes the
same ``%05d_*`` artifact contract, so data prepared by the reference, by
the JAX package and by this package are interchangeable. The stages that
wrap external networks (RAFT optical flow #15, mseg/Panoptic-DeepLab
semantic segmentation #18) take a pluggable estimator callable
(``dataprep/adapters.py``) and otherwise pass precomputed artifacts
through. Everything here is host code: numpy, cv2 and the 4x4 transforms
of ``geometry/se3.py``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from camradepth_tpu_torch.geometry import se3
from camradepth_tpu_torch.models.panoptic_deeplab import VEHICLE_CLASSES

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

DOWNSAMPLE = 2
Y_CUTOFF = 34


# ---------------------------------------------------------------------------
# #13 scene split (scripts/split_trainval.py)
# ---------------------------------------------------------------------------

def build_scene_split(
    nusc,
    train_ratio: float = 0.8,
    val_ratio: float = 0.1,
    mini: bool = False,
    seed: int = 1,
    stop_thresh: float = 0.1,
    corrupt_indices: Sequence[int] = (26198,),
) -> Dict[str, List[int]]:
    """Scene-level split: 'wait' scenes dropped, rain/night separated out,
    clear-day scenes shuffled and cut 80/10/10 (mini: 2/1/1); frames at
    scene edges or with a near-stopped ego in the 4-sample neighborhood are
    excluded; known-corrupt indices removed
    (split_trainval.py:51-145)."""
    rng = np.random.RandomState(seed)
    clear, rain_night = [], []
    for scene in nusc.scene:
        desc = scene["description"].lower()
        if "wait" in desc:
            continue
        (rain_night if ("rain" in desc or "night" in desc) else clear).append(
            scene["token"]
        )
    rng.shuffle(clear)
    rng.shuffle(rain_night)

    if mini:
        n_train, n_val = 2, 1
    else:
        n_train = int(round(len(nusc.scene) * train_ratio))
        n_val = int(round(len(nusc.scene) * val_ratio))
    train_sc = set(clear[:n_train])
    val_sc = set(clear[n_train: n_train + n_val])
    test_sc = set(clear[n_train + n_val:])

    def ego_xy(idx):
        sd = nusc.get("sample_data", nusc.sample[idx]["data"]["LIDAR_TOP"])
        return np.asarray(
            nusc.get("ego_pose", sd["ego_pose_token"])["translation"][:2]
        )

    def moved(idx):
        return float(np.linalg.norm(ego_xy(idx) - ego_xy(idx + 1)))

    def scene_edge(idx):
        s = nusc.sample
        return (
            not s[idx]["prev"] or not s[idx - 1]["prev"]
            or not s[idx]["next"] or not s[idx + 1]["next"]
        )

    def stopped_nearby(idx):
        return any(
            moved(j) < stop_thresh for j in (idx - 2, idx - 1, idx, idx + 1)
        )

    out = {"train": [], "val": [], "test": []}
    for idx, sample in enumerate(nusc.sample):
        if scene_edge(idx) or stopped_nearby(idx):
            continue
        tok = sample["scene_token"]
        if tok in train_sc:
            out["train"].append(idx)
        elif tok in val_sc:
            out["val"].append(idx)
        elif tok in test_sc:
            out["test"].append(idx)
    for bad in corrupt_indices:
        for key in out:
            if bad in out[key]:
                out[key].remove(bad)
    out["all"] = out["train"] + out["val"] + out["test"]
    return out


def save_scene_split(split: Dict[str, List[int]], path: str | Path) -> None:
    Path(path).write_text(json.dumps(split))


def load_scene_split(path: str | Path) -> Dict[str, List[int]]:
    p = Path(path)
    if p.suffix == ".tar":  # reference data_split.tar (torch.save dict)
        import torch

        raw = torch.load(p, weights_only=False)
        return {
            "train": list(raw.get("train_sample_indices", [])),
            "val": list(raw.get("val_sample_indices", [])),
            "test": list(raw.get("test_sample_indices", [])),
            "all": list(raw["all_indices"]),
        }
    return json.loads(p.read_text())


# ---------------------------------------------------------------------------
# #14 image extraction (scripts/prepare_flow_im.py)
# ---------------------------------------------------------------------------

def downsample_image(im: np.ndarray, downsample_scale: int = DOWNSAMPLE,
                     y_cutoff: int = Y_CUTOFF) -> np.ndarray:
    """Bilinear /2 + y-cutoff crop (prepare_flow_im.downsample_im)."""
    h, w = im.shape[:2]
    h2, w2 = int(h / downsample_scale), int(w / downsample_scale)
    if cv2 is None:  # pragma: no cover
        raise RuntimeError("cv2 required")
    out = cv2.resize(im, (w2, h2), interpolation=cv2.INTER_LINEAR)
    return out[y_cutoff:]


def extract_images(nusc, sample_idx: int, out_dir: Path) -> bool:
    """Save cam frames 2&3 (next / next-next of the key CAM_FRONT) as
    %05d_im.jpg / %05d_im_next.jpg (prepare_flow_im.py:64-87)."""
    cam = nusc.get("sample_data", nusc.sample[sample_idx]["data"]["CAM_FRONT"])
    if not cam["next"]:
        return False
    cam2 = nusc.get("sample_data", cam["next"])
    cam3 = nusc.get("sample_data", cam2["next"])
    for rec, suffix in ((cam2, "_im.jpg"), (cam3, "_im_next.jpg")):
        img = cv2.imread(str(Path(nusc.dataroot) / rec["filename"]))
        if img is None:
            raise FileNotFoundError(rec["filename"])
        out = downsample_image(img)
        cv2.imwrite(str(out_dir / f"{sample_idx:05d}{suffix}"), out)
    return True


# ---------------------------------------------------------------------------
# #15 optical flow (scripts/cal_flow.py — external RAFT)
# ---------------------------------------------------------------------------

def compute_flow(
    out_dir: Path,
    sample_idx: int,
    flow_estimator: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]]
    = None,
) -> None:
    """im -> im_next optical flow to %05d_flow.npy. The reference runs
    RAFT-kitti (cal_flow.py:26-93); here any estimator(im1, im2) -> [H,W,2]
    plugs in. Without one, precomputed flow artifacts are expected."""
    if flow_estimator is None:
        raise RuntimeError(
            "no flow estimator configured; provide precomputed *_flow.npy "
            "artifacts or pass flow_estimator (e.g. a RAFT wrapper)"
        )
    im1 = cv2.imread(str(out_dir / f"{sample_idx:05d}_im.jpg"))[..., ::-1]
    im2 = cv2.imread(str(out_dir / f"{sample_idx:05d}_im_next.jpg"))[..., ::-1]
    flow = flow_estimator(im1, im2)
    np.save(out_dir / f"{sample_idx:05d}_flow.npy", flow)


# ---------------------------------------------------------------------------
# #16 camera matrices (scripts/cal_cam_matrix.py)
# ---------------------------------------------------------------------------

def camera_matrices(nusc, sample_idx: int) -> Dict[str, np.ndarray]:
    """K of cam frame 2 and the SE(3) cam3->cam2 transform
    (cal_cam_matrix.py:14-47,74-84)."""
    cam = nusc.get("sample_data", nusc.sample[sample_idx]["data"]["CAM_FRONT"])
    cam1 = nusc.get("sample_data", cam["next"])
    cam2_tok = cam1["next"]

    def cs(rec):
        return nusc.get("calibrated_sensor", rec["calibrated_sensor_token"])

    def pose(rec):
        return nusc.get("ego_pose", rec["ego_pose_token"])

    K = np.array(cs(cam1)["camera_intrinsic"])
    ref, cur = cam1, nusc.get("sample_data", cam2_tok)
    m_ref_from_global = se3.transform_matrix(
        cs(ref)["translation"], cs(ref)["rotation"], True
    ) @ se3.transform_matrix(
        pose(ref)["translation"], pose(ref)["rotation"], True
    )
    m_global_from_cur = se3.transform_matrix(
        pose(cur)["translation"], pose(cur)["rotation"]
    ) @ se3.transform_matrix(cs(cur)["translation"], cs(cur)["rotation"])
    return {"K": K, "T": m_ref_from_global @ m_global_from_cur}


# ---------------------------------------------------------------------------
# #17 flow -> uv (scripts/cal_im_flow2uv.py)
# ---------------------------------------------------------------------------

def flow_to_uv_artifact(out_dir: Path, sample_idx: int) -> None:
    flow = np.load(out_dir / f"{sample_idx:05d}_flow.npy")
    K = np.load(out_dir / f"{sample_idx:05d}_matrix.npz")["K"]
    uv = se3.flow_to_uv(flow.astype(np.float32), K,
                        downsample_scale=DOWNSAMPLE, y_cutoff=Y_CUTOFF)
    np.save(out_dir / f"{sample_idx:05d}_im_uv.npy", uv)


# ---------------------------------------------------------------------------
# #18/#19 semantic segmentation + label remap
# (scripts/semantic_seg.py, scripts/vehicle_seg.py)
# ---------------------------------------------------------------------------

# mseg "universal" class vocabulary (194 classes; indices are positions in
# this list). Only the slice relevant to the remap is reproduced through the
# published class-name tables (vehicle_seg.py:9-31).
MSEG_CLASSES = (
    'backpack', 'umbrella', 'bag', 'tie', 'suitcase', 'case', 'bird', 'cat',
    'dog', 'horse', 'sheep', 'cow', 'elephant', 'bear', 'zebra', 'giraffe',
    'animal_other', 'microwave', 'radiator', 'oven', 'toaster',
    'storage_tank', 'conveyor_belt', 'sink', 'refrigerator', 'washer_dryer',
    'fan', 'dishwasher', 'toilet', 'bathtub', 'shower', 'tunnel', 'bridge',
    'pier_wharf', 'tent', 'building', 'ceiling', 'laptop', 'keyboard',
    'mouse', 'remote', 'cell phone', 'television', 'floor', 'stage',
    'banana', 'apple', 'sandwich', 'orange', 'broccoli', 'carrot',
    'hot_dog', 'pizza', 'donut', 'cake', 'fruit_other', 'food_other',
    'chair_other', 'armchair', 'swivel_chair', 'stool', 'seat', 'couch',
    'trash_can', 'potted_plant', 'nightstand', 'bed', 'table', 'pool_table',
    'barrel', 'desk', 'ottoman', 'wardrobe', 'crib', 'basket',
    'chest_of_drawers', 'bookshelf', 'counter_other', 'bathroom_counter',
    'kitchen_island', 'door', 'light_other', 'lamp', 'sconce', 'chandelier',
    'mirror', 'whiteboard', 'shelf', 'stairs', 'escalator', 'cabinet',
    'fireplace', 'stove', 'arcade_machine', 'gravel', 'platform',
    'playingfield', 'railroad', 'road', 'snow', 'sidewalk_pavement',
    'runway', 'terrain', 'book', 'box', 'clock', 'vase', 'scissors',
    'plaything_other', 'teddy_bear', 'hair_dryer', 'toothbrush', 'painting',
    'poster', 'bulletin_board', 'bottle', 'cup', 'wine_glass', 'knife',
    'fork', 'spoon', 'bowl', 'tray', 'range_hood', 'plate', 'person',
    'rider_other', 'bicyclist', 'motorcyclist', 'paper', 'streetlight',
    'road_barrier', 'mailbox', 'cctv_camera', 'junction_box',
    'traffic_sign', 'traffic_light', 'fire_hydrant', 'parking_meter',
    'bench', 'bike_rack', 'billboard', 'sky', 'pole', 'fence',
    'railing_banister', 'guard_rail', 'mountain_hill', 'rock', 'frisbee',
    'skis', 'snowboard', 'sports_ball', 'kite', 'baseball_bat',
    'baseball_glove', 'skateboard', 'surfboard', 'tennis_racket', 'net',
    'base', 'sculpture', 'column', 'fountain', 'awning', 'apparel',
    'banner', 'flag', 'blanket', 'curtain_other', 'shower_curtain',
    'pillow', 'towel', 'rug_floormat', 'vegetation', 'bicycle', 'car',
    'autorickshaw', 'motorcycle', 'airplane', 'bus', 'train', 'truck',
    'trailer', 'boat_ship', 'slow_wheeled_object', 'river_lake', 'sea',
    'water_other', 'swimming_pool', 'waterfall', 'wall', 'window',
    'window_blind',
)

# 56 kept classes, renumbered 1..56 in list order (vehicle_seg.py:27-31,
# 144-150).
KEPT_CLASSES = (
    'cat', 'dog', 'animal_other', 'tunnel', 'bridge', 'pier_wharf', 'tent',
    'building', 'gravel', 'platform', 'playingfield', 'railroad', 'road',
    'snow', 'sidewalk_pavement', 'runway', 'terrain', 'person',
    'rider_other', 'bicyclist', 'motorcyclist', 'paper', 'streetlight',
    'road_barrier', 'mailbox', 'cctv_camera', 'junction_box',
    'traffic_sign', 'traffic_light', 'fire_hydrant', 'parking_meter',
    'bench', 'bike_rack', 'billboard', 'sky', 'pole', 'fence',
    'railing_banister', 'guard_rail', 'mountain_hill', 'rock', 'vegetation',
    'bicycle', 'car', 'autorickshaw', 'motorcycle', 'airplane', 'bus',
    'truck', 'train', 'trailer', 'boat_ship', 'slow_wheeled_object', 'wall',
    'window', 'window_blind',
)

# 21 merged classes in insertion order -> final labels 0..20
# (vehicle_seg.py:33-53).
MERGED_CLASSES = {
    'animal': ('cat', 'dog', 'animal_other'),
    'tunnel': ('tunnel',),
    'bridge': ('bridge',),
    'building': ('building', 'platform'),
    'road': ('road',),
    'no_drive_road': ('sidewalk_pavement', 'railroad', 'runway'),
    'terrain': ('terrain', 'playingfield'),
    'person': ('person', 'rider_other', 'bicyclist', 'motorcyclist'),
    'pole': ('pole', 'streetlight'),
    'roadbarrier': ('road_barrier',),
    'side_object': ('mailbox', 'junction_box', 'fire_hydrant',
                    'parking_meter'),
    'traffic_sign': ('traffic_sign', 'billboard'),
    'traffic_light': ('traffic_light',),
    'bench': ('bench', 'bike_rack'),
    'sky': ('sky',),
    'fence': ('fence', 'railing_banister', 'guard_rail'),
    'vegetation': ('vegetation', 'mountain_hill', 'rock'),
    'two_wheels': ('bicycle', 'motorcycle', 'slow_wheeled_object'),
    'car': ('car', 'autorickshaw'),
    'truck': ('bus', 'truck', 'trailer'),
    'plane_surface': ('wall', 'window'),
}

IGNORE_LABEL = 255


def mseg_universal_to_kept(labels: np.ndarray) -> np.ndarray:
    """mseg-universal ids -> kept-class ids 1..56 (0 = unknown)
    (vehicle_seg.mseg, :83-107)."""
    uni_index = {name: i for i, name in enumerate(MSEG_CLASSES)}
    lut = np.zeros(256, labels.dtype if labels.dtype.kind == "i" else np.int64)
    for new_id, name in enumerate(KEPT_CLASSES, start=1):
        lut[uni_index[name]] = new_id
    return lut[labels]


def kept_to_merged(labels: np.ndarray) -> np.ndarray:
    """Kept ids 1..56 -> merged labels 0..20, everything else 255
    (vehicle_seg.reduced_mseg, :109-139)."""
    kept_index = {name: i for i, name in enumerate(KEPT_CLASSES, start=1)}
    lut = np.full(256, IGNORE_LABEL, np.int64)
    for merged_id, members in enumerate(MERGED_CLASSES.values()):
        for name in members:
            lut[kept_index[name]] = merged_id
    return lut[np.clip(labels, 0, 255)]


def mseg_to_training_labels(universal: np.ndarray) -> np.ndarray:
    """Full remap: mseg-universal 194-class output -> the 21-class training
    labels with 255 ignore (README §5 two-step flow)."""
    return kept_to_merged(mseg_universal_to_kept(universal))


def vehicle_mask(universal: np.ndarray) -> np.ndarray:
    """Boolean car|bus|truck mask for GT occlusion filtering
    (semantic_seg.py / vehicle_seg.vehicle_seg_only). NOTE: the reference's
    ``np.logical_or(a, b, c)`` passes the truck term as the *out* parameter
    (vehicle_seg.py:70), silently dropping trucks; this implements the
    intended union."""
    uni_index = {name: i for i, name in enumerate(MSEG_CLASSES)}
    ids = [uni_index[n] for n in ("car", "bus", "truck")]
    return np.isin(universal, ids)


# Cityscapes trainIds in order (the label space of the reference's
# OTHER seg producer, Panoptic-DeepLab R101-os32 Cityscapes,
# semantic_seg.py:89-171).
CITYSCAPES_TRAIN_CLASSES = (
    'road', 'sidewalk', 'building', 'wall', 'fence', 'pole',
    'traffic light', 'traffic sign', 'vegetation', 'terrain', 'sky',
    'person', 'rider', 'car', 'truck', 'bus', 'train', 'motorcycle',
    'bicycle',
)

# trainId -> MERGED_CLASSES id (same 21-label training space the mseg
# path produces): every cityscapes class has an exact counterpart
# except 'train' (excluded from MERGED_CLASSES -> 255 ignore, matching
# reduced_mseg's everything-else-255 rule).
_CITYSCAPES_TO_MERGED = (
    4,    # road
    5,    # sidewalk       -> no_drive_road (sidewalk_pavement)
    3,    # building
    20,   # wall           -> plane_surface
    15,   # fence
    8,    # pole
    12,   # traffic light
    11,   # traffic sign
    16,   # vegetation
    6,    # terrain
    14,   # sky
    7,    # person
    7,    # rider          -> person (rider_other/bicyclist/motorcyclist)
    18,   # car
    19,   # truck
    19,   # bus            -> truck group
    255,  # train          (not in MERGED_CLASSES)
    17,   # motorcycle     -> two_wheels
    17,   # bicycle        -> two_wheels
)


def cityscapes_to_training_labels(cls: np.ndarray) -> np.ndarray:
    """Cityscapes trainIds (19-class Panoptic-DeepLab output) -> the
    21-class training labels with 255 ignore: the counterpart of the mseg
    194->56->21 flow, so ``prep --seg jax-panoptic`` writes the same
    artifact contract without the external mseg net."""
    lut = np.full(256, IGNORE_LABEL, np.int64)
    lut[: len(_CITYSCAPES_TO_MERGED)] = _CITYSCAPES_TO_MERGED
    return lut[np.clip(cls, 0, 255)]


def vehicle_mask_cityscapes(cls: np.ndarray) -> np.ndarray:
    """car|truck|bus mask from cityscapes trainIds, as the reference's
    Panoptic-DeepLab path (semantic_seg.py:163-166: classes 13, 14, 15)."""
    return np.isin(cls, VEHICLE_CLASSES)


def semantic_seg_artifact(
    out_dir: Path,
    sample_idx: int,
    seg_estimator: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    remap: str = "merged",
) -> None:
    """Run the pluggable segmentation net on %05d_im.jpg and store the
    remapped labels as %05d_mseg.npy. remap names the estimator's label
    space + target: 'merged'/'vehicle' consume mseg-universal ids
    (194-class), 'cityscapes'/'vehicle_cityscapes' consume cityscapes
    trainIds (the Panoptic-DeepLab path); 'merged'/'cityscapes' emit
    the 21-class training labels, 'vehicle*' the boolean mask."""
    if seg_estimator is None:
        raise RuntimeError(
            "no segmentation estimator configured; provide precomputed "
            "*_mseg.npy artifacts or pass seg_estimator"
        )
    remaps = {
        "merged": mseg_to_training_labels,
        "vehicle": vehicle_mask,
        "cityscapes": cityscapes_to_training_labels,
        "vehicle_cityscapes": vehicle_mask_cityscapes,
    }
    if remap not in remaps:
        raise ValueError(
            f"unknown remap {remap!r}; expected one of {sorted(remaps)}"
        )
    im = cv2.imread(str(out_dir / f"{sample_idx:05d}_im.jpg"))[..., ::-1]
    np.save(
        out_dir / f"{sample_idx:05d}_mseg.npy",
        remaps[remap](seg_estimator(im)),
    )


# ---------------------------------------------------------------------------
# #23 radar filtering by lidar (scripts/depth_difference.py)
# ---------------------------------------------------------------------------

def sid_depth_thresh(gt_depth: np.ndarray, alpha: float = 5.0,
                     beta: float = 16.0, K: float = 100.0):
    """Spacing-increasing depth threshold. The reference computes this and
    then overwrites it with the constant 100 (depth_difference.py:16-17);
    we default to the same effective constant but keep the formula
    available."""
    return np.exp(gt_depth * np.log(beta / alpha) / K + np.log(alpha))


def filter_radar_by_lidar(radar: np.ndarray, gt: np.ndarray,
                          thresh: float = 100.0) -> np.ndarray:
    """Zero radar returns whose |radar - gt| exceeds the threshold
    (depth_difference.filter_radar_by_lidar, :21-38; reference threshold is
    the constant 100)."""
    radar_depth = radar[..., 0]
    gt_depth = gt[..., 0]
    keep = np.abs(radar_depth - gt_depth) <= thresh
    return np.where(keep, radar_depth, 0.0)
