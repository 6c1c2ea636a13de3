"""Synthetic nuScenes-like artifact generator.

The package's own copy of ``camradepth_tpu/data/synthetic.py`` with its
default, contract-shaped noise (``scene=False``): the same seed writes the
same corpus. It writes a miniature ``prepared_data/`` directory with the
reference's per-frame artifact contract (%05d_im.jpg, _radar.npy,
_radar_filtered.npy, _mseg.npy, _im_uv.npy, _rad_vel.npy, _gt.npy) plus a
split table, so the data pipeline, the test harness and serving run end to
end without the nuScenes dataset: sparse radar (~0.1 % fill), semi-dense
GT (~25 % fill), 21-class seg labels with 255 ignore; training steps on
it too. The JAX package's learnable layered scenes (``scene=True``, for
runs meant to show a falling validation loss) are not ported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from camradepth_tpu_torch.data.split import ARTIFACT_SUFFIXES, save_split

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def generate(
    out_dir: str | Path,
    num_frames: int = 8,
    hw=(416, 800),
    seed: int = 0,
    rain_every: int = 4,
) -> Path:
    """Create the artifacts and ``synthetic_split.npy``; returns the split
    path. Every ``rain_every``-th frame has "rain" in its name, which drives
    the edge/sunny metric split (runner.py:468-471)."""
    if cv2 is None:
        raise RuntimeError("cv2 is needed to write the synthetic jpgs")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    h, w = hw
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(num_frames):
        is_rain = bool(rain_every) and i % rain_every == rain_every - 1
        stem = f"{i:05d}_rain" if is_rain else f"{i:05d}"

        img = (rng.uniform(0, 255, (h, w, 3))).astype(np.uint8)
        im_path = out_dir / f"{stem}_im.jpg"
        cv2.imwrite(str(im_path), img)

        # GT: semi-dense depth + uv flow channels (H, W, 3)
        gt = np.zeros((h, w, 3), np.float32)
        gt_mask = rng.uniform(size=(h, w)) < 0.25
        gt[..., 0] = np.where(gt_mask, rng.uniform(1, 120, (h, w)), 0.0)
        gt[..., 1:] = rng.normal(0, 0.1, (h, w, 2)) * gt_mask[..., None]
        np.save(out_dir / f"{stem}_gt.npy", gt)

        # radar: very sparse depth + uv (H, W, 3)
        radar = np.zeros((h, w, 3), np.float32)
        r_mask = rng.uniform(size=(h, w)) < 1e-3
        radar[..., 0] = np.where(r_mask, rng.uniform(1, 100, (h, w)), 0.0)
        radar[..., 1:] = rng.normal(0, 0.1, (h, w, 2)) * r_mask[..., None]
        np.save(out_dir / f"{stem}_radar.npy", radar)
        np.save(out_dir / f"{stem}_radar_filtered.npy",
                radar[..., 0] * (rng.uniform(size=(h, w)) < 0.5))
        np.save(out_dir / f"{stem}_rad_vel.npy",
                (r_mask & (rng.uniform(size=(h, w)) < 0.3)).astype(np.float32))

        # seg labels: 21 classes + scattered 255 ignore
        seg = rng.integers(0, 21, (h, w)).astype(np.int64)
        seg[rng.uniform(size=(h, w)) < 0.05] = 255
        np.save(out_dir / f"{stem}_mseg.npy", seg)

        np.save(out_dir / f"{stem}_im_uv.npy",
                rng.normal(0, 0.2, (h, w, 2)).astype(np.float32))

        rows.append([str(out_dir / f"{stem}{s}") for s in ARTIFACT_SUFFIXES])

    split_path = out_dir / "synthetic_split.npy"
    save_split(rows, split_path)
    return split_path


def main(argv=None) -> int:
    """Corpus generation CLI:

    python -m camradepth_tpu_torch.data.synthetic OUT --frames 64

    Prints the split path; pair with ``cli test --split <path> --set
    data.mini_dataset=1`` to score every row.
    """
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_dir")
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--height", type=int, default=416)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rain-every", type=int, default=4)
    a = p.parse_args(argv)
    print(generate(a.out_dir, num_frames=a.frames, hw=(a.height, a.width),
                   seed=a.seed, rain_every=a.rain_every))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
