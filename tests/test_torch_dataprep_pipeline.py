"""The port's fusions and whole offline prep against the JAX package's, on
the CPU, bit for bit, on the synthetic nuScenes world of
``tests/fake_nuscenes.py``.

- The fusions on one 4-frame scene (1 x 8 samples): ``tracks_for_scene``,
  ``merge_lidar``, ``lidar_maps`` (the native raster), both occlusion
  filters, ``gt_artifacts`` with a vehicle mask, ``merge_radar_sweeps``
  (the 4- and 12-sweep windows) and ``radar_artifacts`` (the radar raster
  in float32, as JAX casts it; against the JAX pipeline's files).
- ``run_pipeline`` of both packages on that world, with synthetic jpgs,
  flow and mseg as ``tests/test_dataprep_pipeline.py`` writes them, through
  the stages ``matrices, uv, gt, radar, filter, split_file``: every
  artifact file equal (the split table's paths rebased). Then each
  package's ``make_loaders`` over its directory: every batch equal, key by
  key. (The JAX test feeds such a batch to a 416x800 model; the port's
  model is held to JAX's elsewhere, so no model runs here.)
- All ten stages of both packages on a 2-frame world with real 900x1600
  camera jpgs, with deterministic stand-in estimators in place of the
  networks (the adapters are tested in ``tests/test_torch_dataprep.py``):
  every file equal.

The JAX package's rasterize_radar runs eagerly, op by op, and compiles
each op for each new point count (~2 s for the world's 4 frames).
"""

import shutil

import cv2
import numpy as np
import pytest

from camradepth_tpu.config import DataConfig as JaxDataConfig
from camradepth_tpu.data.pipeline import make_loaders as jax_make_loaders
from camradepth_tpu.dataprep import lidar_fusion as jax_lidar
from camradepth_tpu.dataprep import radar_fusion as jax_radar
from camradepth_tpu.dataprep import stages as jax_stages
from camradepth_tpu.dataprep.pipeline import run_pipeline as jax_run_pipeline
from camradepth_tpu_torch.config import DataConfig
from camradepth_tpu_torch.data.pipeline import make_loaders
from camradepth_tpu_torch.dataprep import lidar_fusion, radar_fusion, stages
from camradepth_tpu_torch.dataprep.pipeline import ALL_STAGES, run_pipeline
from tests.fake_nuscenes import FakeNuscenes
from tests.torch_port import one_torch_thread  # noqa: F401

STAGES = ("matrices", "uv", "gt", "radar", "filter", "split_file")
HW = (416, 800)


def same(got, want, what=""):
    """Bit for bit, dtype and shape included (NaN = NaN)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


def same_tree(got, want, what=()):
    """Nested dicts / lists of arrays and scalars, equal leaf for leaf."""
    if isinstance(want, dict):
        assert list(got) == list(want), what
        for k in want:
            same_tree(got[k], want[k], what + (k,))
    elif isinstance(want, (list, tuple)) and not isinstance(want, str):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            same_tree(g, w, what + (i,))
    elif isinstance(want, np.ndarray):
        same(got, want, what)
    else:
        assert type(got) is type(want) and got == want, (what, got, want)


def same_dirs(port_dir, jax_dir):
    """Every artifact file of the two directories equal; the split
    tables' paths are each directory's own."""
    names = sorted(p.name for p in jax_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir())
    for name in names:
        got, want = port_dir / name, jax_dir / name
        if name == "split.npy":
            same(np.char.replace(np.load(got), str(port_dir), ""),
                 np.char.replace(np.load(want), str(jax_dir), ""), name)
        elif name.endswith(".npy"):
            same(np.load(got), np.load(want), name)
        elif name.endswith(".npz"):
            g, w = np.load(got), np.load(want)
            assert g.files == w.files, name
            for k in w.files:
                same(g[k], w[k], (name, k))
        else:
            assert got.read_bytes() == want.read_bytes(), name
    return names


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """(world, split, port dir, JAX dir): one 4-frame scene through both
    packages' six host stages, from the same synthetic jpgs, flow and
    mseg (tests/test_dataprep_pipeline.py:17-40)."""
    world = FakeNuscenes(n_scenes=1, samples_per_scene=8)
    tmp = tmp_path_factory.mktemp("prepared")
    jax_dir, port_dir = tmp / "jax", tmp / "port"
    jax_dir.mkdir()
    split = jax_stages.build_scene_split(world, mini=True)
    jax_stages.save_scene_split(split, jax_dir / "data_split.json")
    rng = np.random.default_rng(0)
    for idx in split["all"]:
        img = rng.integers(0, 255, HW + (3,)).astype(np.uint8)
        cv2.imwrite(str(jax_dir / f"{idx:05d}_im.jpg"), img)
        cv2.imwrite(str(jax_dir / f"{idx:05d}_im_next.jpg"), img)
        np.save(jax_dir / f"{idx:05d}_flow.npy",
                rng.normal(0, 1, HW + (2,)).astype(np.float32))
        np.save(jax_dir / f"{idx:05d}_mseg.npy",
                rng.integers(0, 21, HW).astype(np.int64))
    shutil.copytree(jax_dir, port_dir)
    jax_run_pipeline(world, jax_dir, stage_names=STAGES, progress=False)
    run_pipeline(world, port_dir, stage_names=STAGES, progress=False,
                 device="cpu")
    return world, split, port_dir, jax_dir


def test_pipeline_artifacts_match_jax(prepared):
    _, split, port_dir, jax_dir = prepared
    names = same_dirs(port_dir, jax_dir)
    assert len(split["all"]) == 4
    for idx in split["all"]:
        for suffix in ("_matrix.npz", "_im_uv.npy", "_gt.npy", "_msk_lh.npy",
                       "_radar.npy", "_rad_vel.npy", "_radar_filtered.npy"):
            assert f"{idx:05d}{suffix}" in names
    assert "split.npy" in names
    gt = np.load(port_dir / f"{split['all'][0]:05d}_gt.npy")
    assert gt.shape == HW + (3,) and (gt[..., 0] > 0).sum() > 50


def test_loader_batches_from_the_prepared_dir_match_jax(prepared):
    _, _, port_dir, jax_dir = prepared
    kw = dict(image_dimension=HW, mini_dataset=True, num_workers=2)
    ours = make_loaders(DataConfig(split_path=str(port_dir / "split.npy"),
                                   **kw), batch_size=2)
    theirs = jax_make_loaders(
        JaxDataConfig(split_path=str(jax_dir / "split.npy"), **kw),
        batch_size=2)
    got, want = list(ours["test"]), list(theirs["test"])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            same(g[k], w[k], k)
    assert (got[0]["features"][..., 3] != 0).any()  # radar depth arrived
    assert 0 < got[0]["gt_depth"].max() <= 1.0


def test_lidar_fusion_matches_jax(prepared):
    world, split, port_dir, _ = prepared
    idx = split["all"][1]
    tracks = lidar_fusion.tracks_for_scene(world, idx)
    jtracks = jax_lidar.tracks_for_scene(world, idx)
    same_tree(tracks, jtracks)
    assert len(tracks) > 30
    for n_back in (9, 21):
        pts = lidar_fusion.merge_lidar(world, idx, n_back, 42, tracks)
        same_tree(pts, jax_lidar.merge_lidar(world, idx, n_back, 42, tracks))
    maps = lidar_fusion.lidar_maps(pts)
    jmaps = jax_lidar.lidar_maps(pts)
    same_tree(maps, jmaps)
    assert maps["in_box"].any() and maps["low_h"].any()

    # the occlusion filters on these maps, a vehicle mask and a flow that
    # disagrees with the lidar's in places
    rng = np.random.default_rng(1)
    seg = rng.random(maps["depth"].shape) < 0.5
    args = (maps["depth"], seg, maps["in_box"], pts["x_cn"], pts["y_cn"],
            pts["depth_cn"], pts["msk_cn"])
    depth, msk = lidar_fusion.filter_occlusion_by_bbox(*args)
    same_tree((depth, msk), jax_lidar.filter_occlusion_by_bbox(*args))
    assert (depth != maps["depth"]).any()  # some points dropped
    flow_im = maps["flow"] + rng.normal(0, 2.5, maps["flow"].shape)
    fargs = (depth, maps["low_h"] & msk, maps["in_box"],
             maps["flow"] * msk[..., None], flow_im)
    out = lidar_fusion.filter_occlusion_by_flow(*fargs, thres=3.0)
    same_tree(out, jax_lidar.filter_occlusion_by_flow(*fargs, thres=3.0))
    assert (out[0] != depth).any()

    # the whole frame, with a cityscapes vehicle mask as the seg
    K = np.load(port_dir / f"{idx:05d}_matrix.npz")["K"]
    vehicles = stages.vehicle_mask_cityscapes(rng.integers(0, 19, HW))
    art = lidar_fusion.gt_artifacts(world, idx, tracks, K, flow_im, vehicles)
    same_tree(art, jax_lidar.gt_artifacts(world, idx, tracks, K, flow_im,
                                          vehicles))


def test_radar_fusion_matches_jax(prepared):
    world, split, port_dir, jax_dir = prepared
    for idx in split["all"]:
        for frames in ((0, 4), (0, 12)):
            merged = radar_fusion.merge_radar_sweeps(world, idx, frames)
            same_tree(merged, jax_radar.merge_radar_sweeps(world, idx,
                                                           frames))
            assert merged["valid"].any()
    # radar_artifacts against the JAX pipeline's files of every frame
    for idx in split["all"]:
        K = np.load(port_dir / f"{idx:05d}_matrix.npz")["K"]
        art = radar_fusion.radar_artifacts(world, idx, K, device="cpu")
        same(art["radar"], np.load(jax_dir / f"{idx:05d}_radar.npy"), idx)
        same(art["rad_vel"], np.load(jax_dir / f"{idx:05d}_rad_vel.npy"),
             idx)
    assert (art["radar"][..., 0] > 0).sum() > 20


def test_all_ten_stages_match_jax_on_camera_jpgs(tmp_path):
    """images (900x1600 camera jpgs), flow and seg (stand-in estimators
    that read the frames), then the rest: both packages, all ten stages,
    every file equal."""
    world = FakeNuscenes(n_scenes=1, samples_per_scene=6,
                         image_root=tmp_path / "nusc")

    def flow(a, b):
        return ((a[..., :2].astype(np.float32) - b[..., 1:]) / 64.0)

    def seg(im):  # cityscapes trainIds
        return (im[..., 0].astype(np.int64) // 7 + im[..., 2]) % 19

    kw = dict(flow_estimator=flow, seg_estimator=seg, seg_remap="cityscapes",
              mini=True, progress=False)
    jax_run_pipeline(world, tmp_path / "jax", **kw)
    run_pipeline(world, tmp_path / "port", device="cpu", **kw)
    names = same_dirs(tmp_path / "port", tmp_path / "jax")
    for suffix in ("_im.jpg", "_im_next.jpg", "_flow.npy", "_mseg.npy",
                   "_gt.npy", "_radar_filtered.npy"):
        assert sum(n.endswith(suffix) for n in names) == 2, suffix
    assert {"data_split.json", "split.npy"} <= set(names)
    assert len(ALL_STAGES) == 10
