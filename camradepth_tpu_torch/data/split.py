"""Split files: the N x 7 artifact-path table.

The package's own copy of ``camradepth_tpu/data/split.py`` (``load_split``,
``save_split``, ``split_ranges``). The reference persists a numpy array of
shape (N, 7) with per-frame paths ordered [im.jpg, radar.npy,
radar_filtered.npy, mseg.npy, im_uv.npy, rad_vel.npy, gt.npy]
(dataloader.py:64-96), so tables prepared for either package load here.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

ARTIFACT_SUFFIXES = (
    "_im.jpg",
    "_radar.npy",
    "_radar_filtered.npy",
    "_mseg.npy",
    "_im_uv.npy",
    "_rad_vel.npy",
    "_gt.npy",
)


def load_split(path: str | Path) -> np.ndarray:
    """Load an (N, 7) path table (dataloader.py:52-61)."""
    files = np.load(Path(path), allow_pickle=True)
    if files.ndim != 2 or files.shape[1] != len(ARTIFACT_SUFFIXES):
        raise ValueError(
            f"split file {path} has shape {files.shape}, expected (N, 7)"
        )
    return files


def save_split(rows: Sequence[Sequence[str]], path: str | Path) -> Path:
    """Write an (N, 7) table; returns the path numpy wrote."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = np.array([list(r) for r in rows])
    if arr.ndim != 2 or arr.shape[1] != len(ARTIFACT_SUFFIXES):
        raise ValueError(f"rows must be (N, 7), got {arr.shape}")
    np.save(path, arr)
    return path if path.suffix == ".npy" else path.with_suffix(
        path.suffix + ".npy")


def split_ranges(n_total: int, train_val: Sequence[int]):
    """Index ranges for train/val/test given the (train, val) sizes; test
    is the remainder (dataloader.py:36-46, args.py:137)."""
    tr, va = train_val
    return (
        range(0, tr),
        range(tr, tr + va),
        range(tr + va, n_total),
    )
