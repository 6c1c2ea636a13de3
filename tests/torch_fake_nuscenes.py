"""The synthetic nuScenes world of ``tests/fake_nuscenes.py``, free of JAX.

The same world, record for record and point for point, for code that may
not import the JAX package (``chip_smoke.py`` phase (r) drives the port's
offline prep on it): the original imports ``camradepth_tpu.geometry.se3``
(unused), this copy imports nothing of the JAX package, and the world
needs no geometry. ``tests/test_torch_dataprep.py`` holds the two equal.

It implements the subset of the devkit API the dataprep stages consume
(`sample`, `scene`, `get`, `dataroot`, plus direct point loaders) with
procedurally generated geometry: a straight-driving ego, a few static and
moving boxes, lidar points on a ground plane + box surfaces, and radar
returns with Doppler velocities. No files are touched unless
``image_root`` is given; the `load_*_points` hooks bypass the filesystem.
"""

from __future__ import annotations

import numpy as np

CAM_K = np.array([[800.0, 0, 800.0], [0, 800.0, 450.0], [0, 0, 1.0]])


class FakeNuscenes:
    def __init__(self, n_scenes=2, samples_per_scene=10, seed=0,
                 rain_scene_idx=None, sweeps_between=4, image_root=None):
        """``image_root``: when set, actual 900x1600 camera jpgs are
        written under it (one per CAM_FRONT sample_data record) so the
        real `images` dataprep stage (cv2.imread + downsample + y-cutoff)
        can run against this world."""
        rng = np.random.default_rng(seed)
        self.dataroot = str(image_root) if image_root else "/nonexistent"
        self._write_images = image_root is not None
        self.scene = []
        self.sample = []
        self._records = {}
        self._rng = rng
        self._t0 = 1_600_000_000_000_000  # microseconds

        self._cs_cam = self._add(
            "calibrated_sensor",
            {
                "translation": [1.5, 0.0, 1.6],
                "rotation": [0.5, -0.5, 0.5, -0.5],  # cam looks forward
                "camera_intrinsic": CAM_K.tolist(),
            },
        )
        self._cs_lidar = self._add(
            "calibrated_sensor",
            {"translation": [1.0, 0.0, 1.8],
             "rotation": [1.0, 0.0, 0.0, 0.0],
             "camera_intrinsic": []},
        )
        self._cs_radar = self._add(
            "calibrated_sensor",
            {"translation": [2.5, 0.0, 0.5],
             "rotation": [1.0, 0.0, 0.0, 0.0],
             "camera_intrinsic": []},
        )

        for s in range(n_scenes):
            desc = "rain heavy" if s == rain_scene_idx else "clear sunny"
            scene_tok = f"scene-{s}"
            self.scene.append({"token": scene_tok, "description": desc})
            self._build_scene(scene_tok, s, samples_per_scene, sweeps_between)

    # -- devkit surface -----------------------------------------------------
    def get(self, table: str, token: str):
        return self._records[(table, token)]

    def _write_cam_jpg(self, filename: str, ego_x: float) -> None:
        """Deterministic 900x1600 scene image: sky/ground split plus a
        'wall' band whose position tracks the ego (gives LK flow real
        structure to latch onto)."""
        import cv2
        from pathlib import Path

        img = np.full((900, 1600, 3), 96, np.uint8)
        img[:450] = 180  # sky
        wall_u = int(max(0, min(1500, 1500 - ego_x * 10)))
        img[300:650, wall_u: wall_u + 80] = (40, 60, 200)
        img[700:, :] = 70  # road
        path = Path(self.dataroot) / filename
        path.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(path), img)

    def load_radar_points(self, sd_rec) -> np.ndarray:
        return sd_rec["_points"]

    def load_lidar_points(self, sd_rec) -> np.ndarray:
        return sd_rec["_points"]

    # -- construction -------------------------------------------------------
    def _add(self, table, rec, token=None):
        token = token or f"{table}-{len(self._records)}"
        rec = dict(rec)
        rec["token"] = token
        self._records[(table, token)] = rec
        return token

    def _ego_pose(self, t_us, speed=5.0):
        x = speed * (t_us - self._t0) * 1e-6
        return self._add(
            "ego_pose",
            {"translation": [x, 0.0, 0.0],
             "rotation": [1.0, 0.0, 0.0, 0.0],
             "timestamp": t_us},
        )

    def _lidar_cloud(self, ego_x):
        """Ground plane + a wall + points on the moving box (sensor frame)."""
        rng = self._rng
        n = 600
        # ground points ahead
        gx = rng.uniform(5, 80, n)
        gy = rng.uniform(-15, 15, n)
        gz = np.full(n, -1.8)
        # a vertical wall at x=60 (world) -> sensor x = 60 - ego_x
        wn = 200
        wx = np.full(wn, 60.0 - ego_x)
        wy = rng.uniform(-10, 10, wn)
        wz = rng.uniform(-1.5, 2.5, wn)
        pts = np.stack(
            [np.concatenate([gx, wx]), np.concatenate([gy, wy]),
             np.concatenate([gz, wz]),
             np.zeros(n + wn)]
        )
        return pts.astype(np.float64)

    def _radar_cloud(self, ego_x):
        rng = self._rng
        n = 64
        x = rng.uniform(5, 90, n)
        y = rng.uniform(-12, 12, n)
        z = rng.uniform(-0.5, 0.5, n)
        pts = np.zeros((18, n))
        pts[0], pts[1], pts[2] = x, y, z
        pts[5] = rng.uniform(-5, 15, n)  # RCS
        pts[8] = rng.uniform(-2, 2, n)   # vx_comp
        pts[9] = rng.uniform(-1, 1, n)   # vy_comp
        return pts

    def _build_scene(self, scene_tok, scene_idx, n_samples, sweeps_between):
        dt_key = 500_000  # 0.5 s between key frames
        t_start = self._t0 + scene_idx * 60_000_000

        # chains: for each modality, build sample_data chains with sweeps
        def chain(sensor, cs_token, n_inter, make_points=None, t_offset=0):
            toks = []
            n_total = n_samples + (n_samples - 1) * n_inter
            dt = dt_key // (n_inter + 1)
            for i in range(n_total):
                t = t_start + t_offset + i * dt
                ego_x = 5.0 * (t - self._t0) * 1e-6
                ext = (
                    "jpg" if sensor == "cam" and self._write_images
                    else "bin"
                )
                rec = {
                    "ego_pose_token": self._ego_pose(t),
                    "calibrated_sensor_token": cs_token,
                    "timestamp": t,
                    "filename": f"{sensor}-{scene_tok}-{i}.{ext}",
                    "prev": "",
                    "next": "",
                }
                if make_points is not None:
                    rec["_points"] = make_points(ego_x)
                if sensor == "cam" and self._write_images:
                    self._write_cam_jpg(rec["filename"], ego_x)
                tok = self._add("sample_data", rec)
                toks.append(tok)
            for i, tok in enumerate(toks):
                rec = self._records[("sample_data", tok)]
                rec["prev"] = toks[i - 1] if i > 0 else ""
                rec["next"] = toks[i + 1] if i < len(toks) - 1 else ""
            return toks

        lidar = chain("lidar", self._cs_lidar, sweeps_between,
                      self._lidar_cloud)
        radar = chain("radar", self._cs_radar, sweeps_between,
                      self._radar_cloud)
        cam = chain("cam", self._cs_cam, sweeps_between)

        step = sweeps_between + 1
        prev_sample = None
        for i in range(n_samples):
            tok = self._add(
                "sample",
                {
                    "scene_token": scene_tok,
                    "data": {
                        "LIDAR_TOP": lidar[i * step],
                        "RADAR_FRONT": radar[i * step],
                        "CAM_FRONT": cam[i * step],
                    },
                    "anns": [],
                    "prev": "",
                    "next": "",
                },
                token=f"sample-{scene_tok}-{i}",
            )
            rec = self._records[("sample", tok)]
            if prev_sample is not None:
                self._records[("sample", prev_sample)]["next"] = tok
                rec["prev"] = prev_sample
            prev_sample = tok
            self.sample.append(rec)

        # annotations: one parked vehicle + one moving vehicle per scene
        self._add_instance_track(
            scene_tok, n_samples,
            start=np.array([40.0, 2.0, 0.0]), vel=np.array([0.0, 0.0, 0.0]),
            size=[2.0, 4.5, 1.6], category="vehicle.car",
        )
        self._add_instance_track(
            scene_tok, n_samples,
            start=np.array([25.0, -3.0, 0.0]), vel=np.array([3.0, 0.0, 0.0]),
            size=[2.0, 4.5, 1.6], category="vehicle.truck",
        )

    def _add_instance_track(self, scene_tok, n_samples, start, vel, size,
                            category):
        inst = f"inst-{scene_tok}-{category}-{start[0]}"
        samples = [s for s in self.sample if s["scene_token"] == scene_tok]
        ann_tokens = []
        for i, s in enumerate(samples):
            t = self._records[
                ("sample_data", s["data"]["LIDAR_TOP"])
            ]["timestamp"]
            dt = (t - self._records[
                ("sample_data", samples[0]["data"]["LIDAR_TOP"])
            ]["timestamp"]) * 1e-6
            trans = (start + vel * dt).tolist()
            tok = self._add(
                "sample_annotation",
                {
                    "translation": trans,
                    "size": size,
                    "rotation": [1.0, 0.0, 0.0, 0.0],
                    "instance_token": inst,
                    "category_name": category,
                    "prev": "",
                    "next": "",
                },
            )
            ann_tokens.append(tok)
            s["anns"].append(tok)
        for i, tok in enumerate(ann_tokens):
            rec = self._records[("sample_annotation", tok)]
            rec["prev"] = ann_tokens[i - 1] if i > 0 else ""
            rec["next"] = (
                ann_tokens[i + 1] if i < len(ann_tokens) - 1 else ""
            )
