"""Offline preprocessing orchestrator.

Counterpart of ``camradepth_tpu/dataprep/pipeline.py``: one entry point in
place of the reference's ``scripts/preprocess_data.sh`` 11-script
sequence. Stages run per frame over the scene split and write the
reference artifact contract into ``prepared_data/``:

  1 split      -> data_split.json                  (#13)
  2 images     -> %05d_im.jpg, _im_next.jpg        (#14)
  3 flow       -> %05d_flow.npy (pluggable RAFT)   (#15)
  4 matrices   -> %05d_matrix.npz (K, T)           (#16)
  5 uv         -> %05d_im_uv.npy                   (#17)
  6 seg        -> %05d_mseg.npy (pluggable net)    (#18/#19)
  7 gt         -> %05d_gt.npy, _msk_lh.npy         (#12/#20)
  8 radar      -> %05d_radar.npy, _rad_vel.npy     (#11/#21/#22)
  9 filter     -> %05d_radar_filtered.npy          (#23)
 10 split_file -> <out>/split.npy (N x 7 table)    (#24)

The radar stage rasterizes on ``device`` (default ``"cuda"``, which raises
without a card); the flow and seg estimators run where their factories
(``dataprep/adapters.py``) put them. Everything else is host code.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

from camradepth_tpu_torch import resolve_device
from camradepth_tpu_torch.data.split import build_split_from_dir
from camradepth_tpu_torch.dataprep import lidar_fusion, radar_fusion, stages

ALL_STAGES = (
    "split", "images", "flow", "matrices", "uv", "seg", "gt", "radar",
    "filter", "split_file",
)


def run_pipeline(
    nusc,
    out_dir: str | Path,
    stage_names: Sequence[str] = ALL_STAGES,
    mini: bool = False,
    flow_estimator: Optional[Callable] = None,
    seg_estimator: Optional[Callable] = None,
    seg_remap: str = "merged",
    sample_indices: Optional[Iterable[int]] = None,
    radar_frame_range=(0, 4),
    progress: bool = True,
    device="cuda",
) -> Path:
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    split_path = out_dir / "data_split.json"

    if "split" in stage_names:
        split = stages.build_scene_split(nusc, mini=mini)
        stages.save_scene_split(split, split_path)
    else:
        split = stages.load_scene_split(split_path)

    indices = list(sample_indices) if sample_indices is not None else split[
        "all"
    ]

    def log(msg):
        if progress:
            print(f"[dataprep] {msg}", flush=True)

    if "images" in stage_names:
        log(f"images: {len(indices)} frames")
        for idx in indices:
            stages.extract_images(nusc, idx, out_dir)
    if "flow" in stage_names and flow_estimator is not None:
        log("flow")
        for idx in indices:
            stages.compute_flow(out_dir, idx, flow_estimator)
    if "matrices" in stage_names:
        log("matrices")
        for idx in indices:
            m = stages.camera_matrices(nusc, idx)
            np.savez(out_dir / f"{idx:05d}_matrix.npz", **m)
    if "uv" in stage_names:
        log("uv")
        for idx in indices:
            if (out_dir / f"{idx:05d}_flow.npy").exists():
                stages.flow_to_uv_artifact(out_dir, idx)
    if "seg" in stage_names and seg_estimator is not None:
        log("seg")
        for idx in indices:
            stages.semantic_seg_artifact(
                out_dir, idx, seg_estimator, remap=seg_remap
            )
    if "gt" in stage_names:
        log("gt (lidar accumulation)")
        current_scene = None
        box_tracks = None
        for idx in indices:
            scene_tok = nusc.sample[idx]["scene_token"]
            if scene_tok != current_scene:
                current_scene = scene_tok
                box_tracks = lidar_fusion.tracks_for_scene(nusc, idx)
            K = np.load(out_dir / f"{idx:05d}_matrix.npz")["K"]
            flow_path = out_dir / f"{idx:05d}_flow.npy"
            seg_path = out_dir / f"{idx:05d}_mseg.npy"
            flow_im = (
                np.load(flow_path) if flow_path.exists()
                else np.zeros((416, 800, 2), np.float32)
            )
            seg = (
                np.load(seg_path).astype(bool) if seg_path.exists()
                else np.zeros((416, 800), bool)
            )
            # the bbox filter needs the boolean vehicle mask; merged labels
            # also work through their car/truck ids being nonzero is NOT
            # equivalent — callers preparing 21-class labels should run the
            # 'seg' stage twice like the reference README (vehicle pass for
            # gt, merged pass afterward).
            art = lidar_fusion.gt_artifacts(
                nusc, idx, box_tracks, K, flow_im, seg
            )
            np.save(out_dir / f"{idx:05d}_gt.npy", art["gt"])
            np.save(out_dir / f"{idx:05d}_msk_lh.npy", art["msk_lh"])
    if "radar" in stage_names:
        log("radar")
        for idx in indices:
            K = np.load(out_dir / f"{idx:05d}_matrix.npz")["K"]
            art = radar_fusion.radar_artifacts(
                nusc, idx, K, frame_range=radar_frame_range, device=dev
            )
            if art is None:
                continue
            np.save(out_dir / f"{idx:05d}_radar.npy", art["radar"])
            np.save(out_dir / f"{idx:05d}_rad_vel.npy", art["rad_vel"])
    if "filter" in stage_names:
        log("radar filter")
        for idx in indices:
            r = out_dir / f"{idx:05d}_radar.npy"
            g = out_dir / f"{idx:05d}_gt.npy"
            if r.exists() and g.exists():
                filtered = stages.filter_radar_by_lidar(
                    np.load(r), np.load(g)
                )
                np.save(out_dir / f"{idx:05d}_radar_filtered.npy", filtered)
    if "split_file" in stage_names:
        log("split file")
        table = build_split_from_dir(out_dir)
        np.save(out_dir / "split.npy", table)
    return out_dir
