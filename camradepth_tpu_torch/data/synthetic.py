"""Synthetic nuScenes-like artifact generator.

The package's own copy of ``camradepth_tpu/data/synthetic.py``: the same
seed writes the same corpus. It writes a miniature ``prepared_data/``
directory with the reference's per-frame artifact contract (%05d_im.jpg,
_radar.npy, _radar_filtered.npy, _mseg.npy, _im_uv.npy, _rad_vel.npy,
_gt.npy) plus a split table, so the data pipeline, the test harness,
serving and training run end to end without the nuScenes dataset: sparse
radar (~0.1 % fill), semi-dense GT (~25 % fill), 21-class seg labels with
255 ignore. By default every artifact is contract-shaped noise;
``scene=True`` (``--scene``) renders learnable layered scenes instead, the
corpus for runs meant to show a falling validation loss.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from camradepth_tpu_torch.data.split import ARTIFACT_SUFFIXES, save_split

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


# 21-entry class colour wheel (class 0 is background grey): the hue encodes
# the class, independently of the brightness that encodes depth, so the seg
# branch has a signal of its own
_CLASS_COLORS = np.concatenate(
    [np.full((1, 3), 0.5, np.float32),
     0.5 + 0.5 * np.cos(
         2.0 * np.pi * (np.arange(20, dtype=np.float32)[:, None] / 20.0)
         + np.array([0.0, 2.094, 4.189], np.float32))],
    axis=0,
).astype(np.float32)


def _scene(rng, h, w, rain: bool = False):
    """A learnable synthetic scene (``camradepth_tpu/data/synthetic.py:
    40-99``, the same draws in the same order): layered rectangles and
    ellipses whose appearance encodes depth (nearer is brighter) and class
    (a hue of a fixed wheel, drawn per object independently of its depth).
    Returns (img_u8 [H,W,3], depth [H,W] metres, cls [H,W] int64, flow
    [H,W,2]), the flow a parallax k / depth. ``rain`` scenes are dimmer and
    noisier, a real quality gap for the edge/sunny metric split
    (runner.py:468-471)."""
    n_objects = int(rng.integers(8, 23))
    # background: a vertical depth ramp over a random range, with a random
    # horizontal tilt
    far = float(rng.uniform(70.0, 100.0))
    near = float(rng.uniform(15.0, 35.0))
    ramp = np.linspace(far, near, h, dtype=np.float32)[:, None]
    tilt = float(rng.uniform(-0.12, 0.12))
    lateral = 1.0 + tilt * np.linspace(-1.0, 1.0, w,
                                       dtype=np.float32)[None, :]
    depth = (ramp * lateral).astype(np.float32)
    cls = np.zeros((h, w), np.int64)
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    # painted far to near, so nearer objects occlude
    ds = np.sort(rng.uniform(3.0, 70.0, n_objects))[::-1]
    for d in ds:
        c = int(rng.integers(1, 21))  # the class, independent of depth
        scale = np.clip(18.0 / (d + 6.0), 0.06, 0.9)
        oh = max(2, int(h * scale * rng.uniform(0.5, 1.0)))
        ow = max(2, int(w * scale * rng.uniform(0.5, 1.5)))
        y0 = int(rng.uniform(0, max(1, h - oh)))
        x0 = int(rng.uniform(0, max(1, w - ow)))
        if rng.random() < 0.4:  # ellipse
            cy, cx = y0 + oh / 2.0, x0 + ow / 2.0
            m = (((yy - cy) / (oh / 2.0)) ** 2
                 + ((xx - cx) / (ow / 2.0)) ** 2) <= 1.0
        else:  # rectangle
            m = np.zeros((h, w), bool)
            m[y0:y0 + oh, x0:x0 + ow] = True
        depth[m] = d
        cls[m] = c
    # brightness a function of depth, hue of class
    bright = 235.0 * (4.0 / (4.0 + depth))  # near ~220, far ~10
    img = (20.0 + bright)[..., None] * (0.35 + 0.65 * _CLASS_COLORS[cls])
    if rng.random() < 0.5:  # textured scenes: depth-preserving stripes
        period = float(rng.uniform(6.0, 24.0))
        stripes = 1.0 + 0.12 * np.sin(2.0 * np.pi * (xx + 0.7 * yy) / period)
        img = img * stripes[..., None]
    noise_sigma, gain = (11.0, 0.62) if rain else (4.0, 1.0)
    img = np.clip(gain * img + rng.normal(0, noise_sigma, (h, w, 3)), 0,
                  255).astype(np.uint8)
    flow = np.stack(
        [36.0 / depth + rng.normal(0, 0.02, (h, w)).astype(np.float32),
         9.0 / depth + rng.normal(0, 0.02, (h, w)).astype(np.float32)],
        axis=-1,
    ).astype(np.float32)
    return img, depth, cls, flow


def generate(
    out_dir: str | Path,
    num_frames: int = 8,
    hw=(416, 800),
    seed: int = 0,
    rain_every: int = 4,
    scene: bool = False,
) -> Path:
    """Create the artifacts and ``synthetic_split.npy``; returns the split
    path. Every ``rain_every``-th frame has "rain" in its name, which drives
    the edge/sunny metric split (runner.py:468-471). ``scene=True`` samples
    radar, lidar, flow and seg from one rendered world (:func:`_scene`), in
    place of contract-shaped noise."""
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

        if scene:
            img, scene_depth, scene_cls, scene_flow = _scene(
                rng, h, w, rain=is_rain)
        else:
            img = (rng.uniform(0, 255, (h, w, 3))).astype(np.uint8)
        im_path = out_dir / f"{stem}_im.jpg"
        cv2.imwrite(str(im_path), img)

        # GT: semi-dense depth + uv flow channels (H, W, 3)
        gt = np.zeros((h, w, 3), np.float32)
        gt_mask = rng.uniform(size=(h, w)) < 0.25
        if scene:
            gt[..., 0] = np.where(gt_mask, scene_depth, 0.0)
            gt[..., 1:] = scene_flow * gt_mask[..., None]
        else:
            gt[..., 0] = np.where(gt_mask, rng.uniform(1, 120, (h, w)), 0.0)
            gt[..., 1:] = rng.normal(0, 0.1, (h, w, 2)) * gt_mask[..., None]
        np.save(out_dir / f"{stem}_gt.npy", gt)

        # radar: very sparse depth + uv (H, W, 3)
        radar = np.zeros((h, w, 3), np.float32)
        r_mask = rng.uniform(size=(h, w)) < 1e-3
        if scene:
            radar[..., 0] = np.where(
                r_mask,
                scene_depth + rng.normal(0, 0.5, (h, w)).astype(np.float32),
                0.0)
            radar[..., 1:] = scene_flow * r_mask[..., None]
        else:
            radar[..., 0] = np.where(r_mask, rng.uniform(1, 100, (h, w)), 0.0)
            radar[..., 1:] = rng.normal(0, 0.1, (h, w, 2)) * r_mask[..., None]
        np.save(out_dir / f"{stem}_radar.npy", radar)
        np.save(out_dir / f"{stem}_radar_filtered.npy",
                radar[..., 0] * (rng.uniform(size=(h, w)) < 0.5))
        np.save(out_dir / f"{stem}_rad_vel.npy",
                (r_mask & (rng.uniform(size=(h, w)) < 0.3)).astype(np.float32))

        # seg labels: 21 classes + scattered 255 ignore
        if scene:
            seg = scene_cls.copy()
        else:
            seg = rng.integers(0, 21, (h, w)).astype(np.int64)
        seg[rng.uniform(size=(h, w)) < 0.05] = 255
        np.save(out_dir / f"{stem}_mseg.npy", seg)

        np.save(out_dir / f"{stem}_im_uv.npy",
                scene_flow if scene
                else rng.normal(0, 0.2, (h, w, 2)).astype(np.float32))

        rows.append([str(out_dir / f"{stem}{s}") for s in ARTIFACT_SUFFIXES])

    split_path = out_dir / "synthetic_split.npy"
    save_split(rows, split_path)
    return split_path


def main(argv=None) -> int:
    """Corpus generation CLI:

    python -m camradepth_tpu_torch.data.synthetic OUT --frames 64 [--scene]

    Prints the split path; pair with ``cli test --split <path> --set
    data.mini_dataset=1`` to score every row, or with ``cli train --split
    <path> --train-val-split N,M`` on a ``--scene`` corpus.
    """
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_dir")
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--height", type=int, default=416)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rain-every", type=int, default=4)
    p.add_argument("--scene", action="store_true",
                   help="learnable layered scenes (default: contract noise)")
    a = p.parse_args(argv)
    print(generate(a.out_dir, num_frames=a.frames, hw=(a.height, a.width),
                   seed=a.seed, rain_every=a.rain_every, scene=a.scene))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
