"""Split files: the N x 7 artifact-path table.

The package's own copy of ``camradepth_tpu/data/split.py``. The reference
persists a numpy array of shape (N, 7) with per-frame paths ordered
[im.jpg, radar.npy, radar_filtered.npy, mseg.npy, im_uv.npy, rad_vel.npy,
gt.npy] (dataloader.py:64-96), so tables prepared for either package load
here. :func:`validate_split` (``cli validate-data``) checks a table's
artifacts against the frame contract that the loader assumes.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import List, Sequence

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


def build_split_from_dir(dir_data: str | Path) -> np.ndarray:
    """Glob the 7 artifact types and zip the sorted lists into the (N, 7)
    table (create_a_split_file.py:40-67, dataloader.py:128-150). Raises
    where a type has fewer files than there are images."""
    dir_data = str(dir_data)
    if not dir_data.endswith(os.sep):
        dir_data += os.sep
    lists: List[List[str]] = [sorted(glob.glob(dir_data + "*" + suffix))
                              for suffix in ARTIFACT_SUFFIXES]
    counts = {s: len(found) for s, found in zip(ARTIFACT_SUFFIXES, lists)}
    n = counts[ARTIFACT_SUFFIXES[0]]
    if n == 0:
        raise FileNotFoundError(f"no '*_im.jpg' artifacts under {dir_data}")
    missing = {s: c for s, c in counts.items() if c < n}
    if missing:
        raise ValueError(f"artifact count mismatch: {n} images but {missing}")
    return np.array(list(zip(*[found[:n] for found in lists])))


def rebase_split(split: np.ndarray, new_dir: str | Path) -> np.ndarray:
    """Rewrite the directory of every path (the reference's
    create_new_split_file, dataloader.py:101-123)."""
    new_dir = Path(new_dir)
    return np.array(
        [[str(new_dir / Path(p).name) for p in row] for row in split])


# column: (suffix, ndim, trailing channels or None, dtype kinds)
_NPY_SPECS = {
    1: ("_radar.npy", 3, 3, "f"),
    2: ("_radar_filtered.npy", 2, None, "f"),
    3: ("_mseg.npy", 2, None, "iu"),
    4: ("_im_uv.npy", 3, 2, "f"),
    5: ("_rad_vel.npy", 2, None, "f"),
    6: ("_gt.npy", 3, 3, "f"),
}
MAX_ERRORS = 50


def validate_split(rows: np.ndarray,
                   image_dimension: Sequence[int] = (416, 800),
                   limit: int = 0, decode_images: bool = True) -> dict:
    """Check a split table's artifacts against the loader's frame contract
    (``data/channels.assemble_frame``; dataloader.py:225-289). The
    reference zips independently globbed sorted lists
    (create_a_split_file.py:40-67), so one missing artifact shifts the
    columns of every later row: the per-row stem check catches that.

    Per row: the 7 files exist; their basenames share one frame stem; each
    .npy loads (mmap) with the expected rank, shape and dtype kind; the GT
    depth is not negative; the image decodes (cv2). Returns {"checked": n,
    "ok": bool, "errors": [(row, message), ...]}, at most
    :data:`MAX_ERRORS` errors. ``limit`` checks the first rows only (0 =
    all); ``decode_images=False`` skips the jpg decode."""
    h, w = image_dimension
    errors: List[tuple] = []
    n = len(rows) if limit <= 0 else min(limit, len(rows))

    def err(i, msg):
        if len(errors) < MAX_ERRORS:
            errors.append((i, msg))

    for i in range(n):
        row = rows[i]
        stems = set()
        missing = False
        for c, p in enumerate(row):
            p = str(p)
            name = os.path.basename(p)
            suffix = ARTIFACT_SUFFIXES[c]
            if not name.endswith(suffix):
                err(i, f"col {c}: {name!r} does not end with {suffix!r}")
            else:
                stems.add(name[: -len(suffix)])
            if not os.path.exists(p):
                err(i, f"col {c}: missing file {p}")
                missing = True
        if len(stems) > 1:
            err(i, f"misaligned row: frame stems differ {sorted(stems)} "
                   "(a missing artifact shifted the sorted-glob zip)")
        if missing:
            continue
        for c, (suffix, ndim, ch, kind) in _NPY_SPECS.items():
            try:
                a = np.load(str(row[c]), mmap_mode="r")
            except Exception as e:
                err(i, f"col {c} ({suffix}): unreadable — {e}")
                continue
            if a.ndim != ndim or (ch and a.shape[-1] != ch):
                err(i, f"col {c} ({suffix}): shape {a.shape}, expected "
                       f"ndim {ndim}" + (f" x{ch}ch" if ch else ""))
                continue
            if a.dtype.kind not in kind:
                err(i, f"col {c} ({suffix}): dtype {a.dtype}, expected "
                       f"kind in {kind!r}")
                continue
            if c != 3 and a.shape[:2] != (h, w):
                err(i, f"col {c} ({suffix}): spatial {a.shape[:2]}, "
                       f"expected {(h, w)}")
            if c == 3 and a.shape[1] != w:
                # mseg may be taller (the loader crops its rows to h), but
                # its width must match
                err(i, f"col 3 (_mseg.npy): width {a.shape[1]} != {w}")
            if c == 6 and float(a[..., 0].min()) < 0:
                err(i, "col 6 (_gt.npy): negative depth values")
        if decode_images:
            try:
                import cv2
            except ImportError:  # pragma: no cover
                continue
            img = cv2.imread(str(row[0]))
            if img is None:
                err(i, f"col 0: cv2 cannot decode {row[0]}")
            elif img.shape[2] != 3:
                err(i, f"col 0: image shape {img.shape}")
    return {"checked": n, "ok": not errors, "errors": errors}


def split_ranges(n_total: int, train_val: Sequence[int]):
    """Index ranges for train/val/test given the (train, val) sizes; test
    is the remainder (dataloader.py:36-46, args.py:137)."""
    tr, va = train_val
    return (
        range(0, tr),
        range(tr, tr + va),
        range(tr + va, n_total),
    )
