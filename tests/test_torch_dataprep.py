"""The port's offline data prep (``camradepth_tpu_torch/dataprep``, the
raster section of ``native.py``, ``cli prep`` and the ``--mini-dataset``
and ``--tpu-tuned`` flags) against the JAX package's, on the CPU, bit for
bit.

- The native raster: ``raster_min_depth_host`` and ``quantize_pixels_host``
  against the JAX package's (its native build) and against the numpy plain
  versions, on a matrix of ties in depth, invalid points, points off the
  grid and pixel ids past it, and payloads empty, of width 1, of width 2
  and mixed; ``raster_min_depth_batch_host`` at 1 and 3 threads against a
  per-frame loop; a failed build raises ``NativeCompileError``.
- The stages: the scene split, its ``.json`` and reference ``.tar``
  files, the camera matrices, every label table over every input id,
  ``downsample_image`` and ``extract_images`` on real 900x1600 camera jpgs,
  the seg artifact under each remap, the radar filter.
- The adapters: the TorchScript routes on the scripted stand-ins of
  ``tests/test_adapters.py``; the factories' kind names and refusals; the
  RAFT adapter on a 60x70 pair = the port's RAFT-large on the edge-padded
  64x72 pair, cropped (the RAFT itself is held to JAX in
  ``tests/test_torch_estimators.py``).
- The CLI: ``cli prep``'s label-space refusal and missing-devkit answer
  (exit code and first stderr line); the two flags' config on every command
  that takes them against JAX's ``_build_config``, field for field;
  ``search --tpu-tuned --vmap-trials`` refused by name.
- ``tests/torch_fake_nuscenes.py`` = ``tests/fake_nuscenes.py`` record for
  record and point for point, for two seeds.

The fusions and the whole pipeline are in
``tests/test_torch_dataprep_pipeline.py``.
"""

import ast
import contextlib
import dataclasses
import io
import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from camradepth_tpu import cli as jax_cli
from camradepth_tpu import native as jax_native
from camradepth_tpu.dataprep import adapters as jax_adapters
from camradepth_tpu.dataprep import stages as jax_stages
from camradepth_tpu_torch import cli, native
from camradepth_tpu_torch.dataprep import adapters, lidar_fusion, stages
from camradepth_tpu_torch.models import raft
from tests.fake_nuscenes import FakeNuscenes
from tests.test_adapters import TinyRaft, TinySegHead
from tests.torch_fake_nuscenes import FakeNuscenes as TwinNuscenes
from tests.torch_port import one_torch_thread  # noqa: F401


def same(got, want, what=""):
    """Bit for bit, dtype and shape included (NaN = NaN)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


def same_maps(got, want, what=""):
    """Two (depth, {name: map}) raster results, bit for bit."""
    same(got[0], want[0], (what, "depth"))
    assert list(got[1]) == list(want[1]), what
    for k in want[1]:
        same(got[1][k], want[1][k], (what, k))


# ---------------------------------------------------------------- raster

H_IM, W_IM, SCALE = 60, 80, 2.0
H_OUT, W_OUT = int(H_IM / SCALE), int(W_IM / SCALE)
NPIX = H_OUT * W_OUT


def raster_points(seed, n=4000):
    """n points on a 30x40 grid (~3 a pixel): 12 distinct depths (ties), 10 %
    invalid, 10 % off the full-resolution image on each side, and a tenth
    of the pixel ids moved past the grid."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1 * W_IM, 1.1 * W_IM, n)
    y = rng.uniform(-0.1 * H_IM, 1.1 * H_IM, n)
    valid = rng.random(n) > 0.1
    depth = rng.choice(rng.uniform(2, 100, 12), n)
    payloads = {"empty": {},
                "width1": {"rcs": rng.normal(size=n)},
                "width2": {"flow": rng.normal(size=(n, 2))},
                "mixed": {"a": rng.normal(size=n) > 0,
                          "flow": rng.normal(size=(n, 2)).astype(np.float32),
                          "b": rng.integers(0, 9, n)}}
    return x, y, valid, depth, payloads


@pytest.mark.parametrize("valid_mask", [True, False])
@pytest.mark.parametrize("scale", [2.0, 1.0])
def test_quantize_pixels_matches_jax_and_numpy(valid_mask, scale):
    x, y, valid, _, _ = raster_points(0)
    valid = valid if valid_mask else None
    h, w = int(H_IM / scale), int(W_IM / scale)
    got = native.quantize_pixels_host(x, y, valid, scale, h, w)
    want = jax_native.quantize_pixels_host(x, y, valid, scale, h, w)
    plain = native.quantize_pixels_numpy(x, y, valid, scale, h, w)
    assert jax_native.available()  # JAX's answer is its native build's
    for g, wt, p, name in zip(got, want, plain, ("pix", "xq", "yq")):
        same(g, wt, name)
        same(g, p, name)
    assert (got[0] < 0).sum() == (0 if valid is None else (~valid).sum())


def test_quantize_pixels_at_exact_halves():
    """Where (c + 0.5) / s - 0.5 lands on k + 0.5, the C code's llround
    rounds away from zero and numpy's round to even: the native path is
    the JAX package's native path there (the prep's), and the plain
    version, like the JAX package's numpy fallback, rounds to even."""
    x = np.array([1.5, 3.5, 5.5, 7.5])  # xq = 0.5, 1.5, 2.5, 3.5
    y = np.zeros(4)
    got = native.quantize_pixels_host(x, y, None, 2.0, H_OUT, W_OUT)
    same(got[0], jax_native.quantize_pixels_host(x, y, None, 2.0, H_OUT,
                                                 W_OUT)[0])
    same(got[0], [1, 2, 3, 4])
    same(native.quantize_pixels_numpy(x, y, None, 2.0, H_OUT, W_OUT)[0],
         [0, 2, 2, 4])


@pytest.mark.parametrize("payload", ["empty", "width1", "width2", "mixed"])
def test_raster_min_depth_matches_jax_and_numpy(payload, monkeypatch):
    x, y, valid, depth, payloads = raster_points(1)
    pix, _, _ = native.quantize_pixels_host(x, y, valid, SCALE, H_OUT, W_OUT)
    pix[::10] += NPIX  # past the grid: dropped
    pay = payloads[payload]
    got = native.raster_min_depth_host(pix, depth, pay, NPIX)
    same_maps(got, jax_native.raster_min_depth_host(pix, depth, pay, NPIX),
              "jax native")
    same_maps(got, native.raster_min_depth_numpy(pix, depth, pay, NPIX),
              "port numpy")
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    same_maps(got, jax_native.raster_min_depth_host(pix, depth, pay, NPIX),
              "jax numpy")
    # the tie rule, shown: of equal least depths the first point wins
    hit = got[0] > 0
    assert hit.sum() > 200
    if payload == "width1":
        keep = (pix >= 0) & (pix < NPIX)
        first = {}
        for i in np.flatnonzero(keep):
            p = pix[i]
            if p not in first or depth[i] < depth[first[p]]:
                first[p] = i
        ids = np.array(sorted(first))
        same(got[1]["rcs"][ids], pay["rcs"][[first[p] for p in ids]])


@pytest.mark.parametrize("threads", [1, 3])
def test_raster_batch_matches_a_per_frame_loop(threads):
    rng = np.random.default_rng(2)
    sizes = [700, 0, 1300, 50, 900]  # an empty frame among them
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    n = offsets[-1]
    pix = rng.integers(-20, NPIX + 20, n)
    depth = rng.choice(rng.uniform(2, 100, 30), n)
    pay = {"flow": rng.normal(size=(n, 2)), "t": rng.normal(size=n)}
    got = native.raster_min_depth_batch_host(pix, depth, pay, offsets, NPIX,
                                             n_threads=threads)
    for f in range(len(sizes)):
        a, b = offsets[f], offsets[f + 1]
        want = native.raster_min_depth_host(
            pix[a:b], depth[a:b], {k: v[a:b] for k, v in pay.items()}, NPIX)
        same_maps((got[0][f], {k: v[f] for k, v in got[1].items()}), want,
                  f)


def test_raster_refuses_arrays_the_c_code_would_overrun():
    n = np.zeros(4)
    with pytest.raises(ValueError, match="expected 4 points"):
        native.quantize_pixels_host(n, np.zeros(3), None, SCALE, H_OUT, W_OUT)
    with pytest.raises(ValueError, match="expected 4 points"):
        native.quantize_pixels_host(n, n, np.ones(5, bool), SCALE, H_OUT,
                                    W_OUT)
    with pytest.raises(ValueError, match="expected 4 points"):
        native.raster_min_depth_host(np.zeros(3, np.int64), n, {}, NPIX)
    for offsets in ([0, 2, 5], [1, 4], [0, 3, 2, 4], []):
        with pytest.raises(ValueError, match="offsets"):
            native.raster_min_depth_batch_host(np.zeros(4, np.int64), n, {},
                                               offsets, NPIX)


def test_failed_build_raises(monkeypatch, tmp_path):
    """The prep's raster does not fall back to numpy, as the JAX package's
    does: a compiler that does not exist raises with its reason."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "GXX", str(tmp_path / "no-such-g++"))
    pts = {k: np.zeros(3) for k in ("x1", "y1", "x2", "y2", "depth1")}
    pts.update(low_h=np.zeros(3, bool), in_box=np.zeros(3))
    with pytest.raises(native.NativeCompileError, match="no-such-g"):
        lidar_fusion.lidar_maps(pts)
    assert native._lib is None


# ---------------------------------------------------------------- stages

@pytest.fixture(scope="module")
def world():
    return FakeNuscenes(n_scenes=3, samples_per_scene=8, rain_scene_idx=1)


@pytest.mark.parametrize("mini", [True, False])
def test_scene_split_matches_jax(world, mini, tmp_path):
    split = stages.build_scene_split(world, mini=mini)
    assert split == jax_stages.build_scene_split(world, mini=mini)
    assert split["all"]
    stages.save_scene_split(split, tmp_path / "s.json")
    assert (tmp_path / "s.json").read_text() == json.dumps(split)
    for load in (stages.load_scene_split, jax_stages.load_scene_split):
        assert load(tmp_path / "s.json") == split


def test_load_scene_split_reads_the_reference_tar(tmp_path):
    raw = {"train_sample_indices": [3, 9], "val_sample_indices": [11],
           "all_indices": [3, 9, 11, 40]}
    torch.save(raw, tmp_path / "data_split.tar")
    got = stages.load_scene_split(tmp_path / "data_split.tar")
    assert got == jax_stages.load_scene_split(tmp_path / "data_split.tar")
    assert got == {"train": [3, 9], "val": [11], "test": [],
                   "all": [3, 9, 11, 40]}


def test_camera_matrices_match_jax(world):
    for idx in jax_stages.build_scene_split(world, mini=True)["all"]:
        got = stages.camera_matrices(world, idx)
        want = jax_stages.camera_matrices(world, idx)
        assert list(got) == list(want) == ["K", "T"]
        for k in want:
            same(got[k], want[k], (idx, k))


def test_label_tables_match_jax_on_every_id():
    mseg = np.concatenate([np.arange(194), [255]])
    kept = np.concatenate([np.arange(57), [255]])
    city = np.concatenate([np.arange(19), [255]])
    for dtype in (np.int64, np.int32, np.uint8):
        for fn, ids in (("mseg_universal_to_kept", mseg),
                        ("kept_to_merged", kept),
                        ("mseg_to_training_labels", mseg),
                        ("vehicle_mask", mseg),
                        ("cityscapes_to_training_labels", city),
                        ("vehicle_mask_cityscapes", city)):
            ids = ids.astype(dtype)
            same(getattr(stages, fn)(ids), getattr(jax_stages, fn)(ids),
                 (fn, dtype))
    for name in ("MSEG_CLASSES", "KEPT_CLASSES", "MERGED_CLASSES",
                 "CITYSCAPES_TRAIN_CLASSES", "IGNORE_LABEL", "DOWNSAMPLE",
                 "Y_CUTOFF"):
        assert getattr(stages, name) == getattr(jax_stages, name), name
    assert stages.vehicle_mask_cityscapes(city).sum() == 3


@pytest.mark.parametrize("remap", ["merged", "vehicle", "cityscapes",
                                   "vehicle_cityscapes"])
def test_seg_artifact_matches_jax(remap, tmp_path):
    rng = np.random.default_rng(5)
    cv2.imwrite(str(tmp_path / "00007_im.jpg"),
                rng.integers(0, 256, (24, 40, 3)).astype(np.uint8))
    n = 19 if "cityscapes" in remap else 194

    def est(im):  # a class map that reads the RGB frame
        return (im.astype(np.int64).sum(-1) * 7 + np.arange(40)) % n

    arts = []
    for mod, sub in ((stages, "port"), (jax_stages, "jax")):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "00007_im.jpg").write_bytes(
            (tmp_path / "00007_im.jpg").read_bytes())
        mod.semantic_seg_artifact(tmp_path / sub, 7, est, remap=remap)
        arts.append(np.load(tmp_path / sub / "00007_mseg.npy"))
    same(*arts, remap)
    with pytest.raises(ValueError, match="unknown remap"):
        stages.semantic_seg_artifact(tmp_path / "port", 7, est, remap="x")
    with pytest.raises(RuntimeError, match="no segmentation estimator"):
        stages.semantic_seg_artifact(tmp_path / "port", 7, None)
    with pytest.raises(RuntimeError, match="no flow estimator"):
        stages.compute_flow(tmp_path / "port", 7, None)


def test_radar_filter_and_threshold_match_jax():
    rng = np.random.default_rng(6)
    radar = rng.uniform(0, 150, (20, 30, 3))
    gt = rng.uniform(0, 150, (20, 30, 3))
    gt[::3] = 0.0
    for thresh in (100.0, 10.0):
        same(stages.filter_radar_by_lidar(radar, gt, thresh),
             jax_stages.filter_radar_by_lidar(radar, gt, thresh))
    same(stages.sid_depth_thresh(gt[..., 0]),
         jax_stages.sid_depth_thresh(gt[..., 0]))


def test_images_match_jax_on_camera_jpgs(tmp_path):
    """downsample_image on a seeded frame, and extract_images on real
    900x1600 camera jpgs of an image_root world: the same bytes."""
    rng = np.random.default_rng(8)
    im = rng.integers(0, 256, (90, 161, 3)).astype(np.uint8)
    for kw in ({}, dict(downsample_scale=3, y_cutoff=5)):
        same(stages.downsample_image(im, **kw),
             jax_stages.downsample_image(im, **kw))
    w = FakeNuscenes(n_scenes=1, samples_per_scene=3, sweeps_between=1,
                     image_root=tmp_path / "nusc")
    for mod, sub in ((stages, "port"), (jax_stages, "jax")):
        (tmp_path / sub).mkdir()
        assert mod.extract_images(w, 0, tmp_path / sub)
        assert not mod.extract_images(w, 2, tmp_path / sub)  # no next cam
    for name in ("00000_im.jpg", "00000_im_next.jpg"):
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name
        assert cv2.imread(str(tmp_path / "port" / name)).shape == (416, 800,
                                                                   3)


# ---------------------------------------------------------------- adapters

@pytest.fixture(scope="module")
def scripted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scripted")
    torch.manual_seed(0)
    torch.jit.script(TinyRaft()).save(str(tmp / "raft.ts"))
    torch.jit.script(TinySegHead()).save(str(tmp / "seg.ts"))
    return tmp / "raft.ts", tmp / "seg.ts"


def test_torchscript_routes_match_jax(scripted):
    raft_ts, seg_ts = scripted
    rng = np.random.RandomState(0)
    im1 = rng.randint(0, 255, (30, 50, 3), dtype=np.uint8)
    im2 = rng.randint(0, 255, (30, 50, 3), dtype=np.uint8)
    for kind in ("raft", "torchscript"):
        got = adapters.make_flow_estimator(kind, ckpt=str(raft_ts),
                                           device="cpu")(im1, im2)
        same(got, jax_adapters.make_flow_estimator(
            kind, ckpt=str(raft_ts))(im1, im2), kind)
        assert got.shape == (30, 50, 2)
    im = rng.randint(0, 255, (33, 47, 3), dtype=np.uint8)
    for kind in ("torchscript", "panoptic-deeplab"):
        got = adapters.make_seg_estimator(kind, ckpt=str(seg_ts),
                                          device="cpu")(im)
        same(got, jax_adapters.make_seg_estimator(kind,
                                                  ckpt=str(seg_ts))(im), kind)
    same(adapters.raft_flow_from_torchscript(raft_ts, device="cpu",
                                             iters=3)(im1, im2),
         jax_adapters.raft_flow_from_torchscript(raft_ts, iters=3)(im1, im2))


def test_factories_keep_the_jax_kind_names_and_refusals():
    assert adapters.make_flow_estimator("none") is None
    assert adapters.make_flow_estimator("") is None
    assert adapters.make_seg_estimator("none") is None
    lk = adapters.make_flow_estimator("lk", device="cpu")
    assert lk.func.__module__ == "camradepth_tpu_torch.ops.optical_flow"
    assert lk.keywords == {"device": "cpu"}
    for make, jmake, kinds in (
            (adapters.make_flow_estimator, jax_adapters.make_flow_estimator,
             ("jax-raft", "raft", "torchscript", "no-such-kind")),
            (adapters.make_seg_estimator, jax_adapters.make_seg_estimator,
             ("jax-panoptic", "torchscript", "panoptic-deeplab", "nope"))):
        for kind in kinds:
            with pytest.raises(ValueError) as want:
                jmake(kind)
            with pytest.raises(ValueError) as got:
                make(kind, device="cpu")
            assert str(got.value) == str(want.value), kind


def test_raft_adapter_pads_by_edge_and_crops(tmp_path):
    """60x70 is no multiple of 8: the adapter = the port's RAFT-large on the
    edge-padded 64x72 pair, cropped; the official checkpoint's layout
    (``module.`` keys under ``state_dict``) loads."""
    torch.manual_seed(3)
    state = raft.RAFT().state_dict()
    torch.save({"state_dict": {f"module.{k}": v for k, v in state.items()}},
               tmp_path / "raft-things.pth")
    rng = np.random.default_rng(9)
    im1 = rng.integers(0, 256, (60, 70, 3)).astype(np.uint8)
    im2 = np.roll(im1, (1, 2), axis=(0, 1))
    est = adapters.make_flow_estimator(
        "jax-raft", ckpt=str(tmp_path / "raft-things.pth"), device="cpu",
        iters=2)
    got = est(im1, im2)
    pad = lambda a: np.pad(a, ((0, 4), (0, 2), (0, 0)), mode="edge")
    want = raft.raft_flow_fn(state, iters=2, device="cpu")(
        pad(im1)[None], pad(im2)[None])[0, :60, :70].numpy()
    same(got, want)
    assert np.abs(got).max() > 0


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from camradepth_tpu_torch.dataprep import radar_fusion
    from camradepth_tpu_torch.dataprep.pipeline import run_pipeline

    w = FakeNuscenes(n_scenes=1, samples_per_scene=4)
    im = np.zeros((16, 16, 3), np.uint8)
    for call in (lambda: run_pipeline(w, tmp_path, stage_names=()),
                 lambda: radar_fusion.radar_artifacts(w, 1, np.eye(3)),
                 lambda: adapters.make_flow_estimator("lk")(im, im),
                 lambda: adapters.raft_flow_from_torchscript("x.ts"),
                 lambda: adapters.seg_classmap_from_torchscript("x.ts")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ---------------------------------------------------------------- CLI

def run(main, argv):
    """(exit code, stderr) of an in-process CLI call."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(
            io.StringIO()):
        rc = main(argv)
    return rc, err.getvalue()


@pytest.mark.parametrize("argv", [
    ["--seg", "jax-panoptic", "--seg-remap", "merged"],
    ["--seg", "torchscript", "--seg-remap", "cityscapes"],
    ["--seg", "panoptic-deeplab", "--seg-remap", "vehicle_cityscapes"],
    [],  # no devkit
    ["--seg", "jax-panoptic", "--seg-remap", "vehicle_cityscapes",
     "--flow", "jax-raft"],  # no devkit: before the estimators
])
def test_cli_prep_answers_as_jax(argv, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "nuscenes", None)  # the devkit absent
    argv = ["prep", "--data-root", str(tmp_path), "--out",
            str(tmp_path / "out")] + argv
    got = run(cli.main, argv + ["--device", "cpu"])
    want = run(jax_cli.main, argv)
    assert got[0] == want[0] == 2
    assert got[1].splitlines()[0] == want[1].splitlines()[0]
    assert not (tmp_path / "out").exists()


COMMANDS = {"train": [], "distill": ["--teacher-checkpoint", "t.pth"],
            "search": [], "test": [], "serve": [],
            "export": ["--out", "a.pt2"]}
FLAG_SETS = ([], ["--mini-dataset"], ["--tpu-tuned"],
             ["--tpu-tuned", "--mini-dataset", "--wire", "off"],
             ["--tpu-tuned", "--preset", "sup_unsup_seg", "--set",
              "model.remat_decoder=false"])
TRAIN_SETS = (["--tpu-tuned", "--batch-size", "4"],
              ["--tpu-tuned", "--desired-batch-size", "12",
               "--pad-microbatch", "7"])


def parsed(main, module, argv, monkeypatch):
    """The argparse namespace that ``main(argv)`` hands its command."""
    got = []
    fn = "cmd_" + argv[0]
    monkeypatch.setattr(module, fn, lambda a: got.append(a) or 0)
    assert main(argv) == 0
    return got[0]


@pytest.mark.parametrize("command", list(COMMANDS))
def test_mini_and_tuned_flags_give_jax_config(command, monkeypatch):
    sets = FLAG_SETS + (TRAIN_SETS if command in ("train", "distill",
                                                  "search") else ())
    build = (cli._build_train_config if command in ("train", "distill",
                                                    "search")
             else cli._build_config)
    for flags in sets:
        argv = [command] + COMMANDS[command] + flags
        got = build(parsed(cli.main, cli, argv, monkeypatch))
        want = jax_cli._build_config(parsed(jax_cli.main, jax_cli, argv,
                                            monkeypatch))
        for section in ("model", "data", "train"):
            g, w = getattr(got, section), getattr(want, section)
            for f in dataclasses.fields(g):
                assert getattr(g, f.name) == getattr(w, f.name), (
                    argv, section, f.name)
        if "--tpu-tuned" in flags:
            assert got.train.pad_microbatch_to in (7, 8)
            assert got.model.remat_encoder
        assert got.data.mini_dataset == ("--mini-dataset" in flags)


def test_search_refuses_tpu_tuned_under_vmap_trials():
    rc, err = run(cli.main, ["search", "--tpu-tuned", "--vmap-trials",
                             "--device", "cpu"])
    assert rc == 2
    assert "--tpu-tuned" in err and "--vmap-trials" in err


# ---------------------------------------------------------------- world

def records(w):
    return {k: v for k, v in w._records.items()}


@pytest.mark.parametrize("seed", [0, 5])
def test_twin_world_equals_fake_nuscenes(seed):
    kw = dict(n_scenes=2, samples_per_scene=5, seed=seed, rain_scene_idx=1,
              sweeps_between=2)
    a, b = FakeNuscenes(**kw), TwinNuscenes(**kw)
    assert a.scene == b.scene and a.dataroot == b.dataroot
    assert [s["token"] for s in a.sample] == [s["token"] for s in b.sample]
    ra, rb = records(a), records(b)
    assert list(ra) == list(rb)
    n_points = 0
    for key, rec in ra.items():
        assert list(rec) == list(rb[key]), key
        for f, v in rec.items():
            if isinstance(v, np.ndarray):
                same(rb[key][f], v, (key, f))
                n_points += v.shape[1]
            else:
                assert rb[key][f] == v, (key, f)
    assert n_points > 10_000
    src = Path(__file__).with_name("torch_fake_nuscenes.py").read_text()
    imported = [n.module if isinstance(n, ast.ImportFrom)
                else n.names[0].name for n in ast.walk(ast.parse(src))
                if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not [m for m in imported if m and m.split(".")[0] in (
        "jax", "camradepth_tpu")], imported
