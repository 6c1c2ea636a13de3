"""The port's native host code (camradepth_tpu_torch.native, the C++ frame
assembler and wire encoder) against the port's numpy paths and the JAX
package's numpy paths (``native_assemble=False``), on the CPU.

- The frame assembler: the matrix of ``tests/test_native.py`` at 64x128
  (float32 and float64 sources with planted NaNs; int64, int32 and uint8
  ``mseg``; the configs ``base``, ``filtered``, ``im_uv`` and
  ``rgbd_only``, whose 7, 4, 9 and 4 channels write the strided feature
  buffer at odd offsets), and one 416x800 frame: every key bit for bit,
  dtype included.
- The wire encoder, with sparse and dense GT, NaN and -0.0 sources: the
  same. An overflow raises the numpy path's text on both paths; a label
  outside uint8 leaves the native path and raises the numpy path's.
- The routing, shown by ``native.counts``: the default config takes the
  native path; sparse_lidar, an fp16 or a non-contiguous source, and a
  GT of another shape than (H, W) take numpy, with the same result.
- The build: a compiler that does not exist, or that fails, raises with
  its reason and names ``data.native_assemble=false`` (no silent
  fallback); two threads that reach the first use together share one
  build.
"""

import dataclasses
import threading

import numpy as np
import pytest

from camradepth_tpu.config import DataConfig as JaxDataConfig
from camradepth_tpu.data import channels as jax_channels
from camradepth_tpu.data import wire as jax_wire
from camradepth_tpu_torch import native
from camradepth_tpu_torch.config import DataConfig
from camradepth_tpu_torch.data import channels, wire

HW = (64, 128)
CONFIGS = {
    "base": {},
    "filtered": dict(filtered_radar=True),
    "im_uv": dict(im_uv=True),
    "rgbd_only": dict(sparse_depth_uv=False, rad_vel=False),
}
WIRE_CONFIGS = ("base", "filtered", "rgbd_only")


def cfgs(name, hw=HW, **extra):
    """(port native, port numpy, JAX numpy) DataConfigs of ``name``."""
    kw = dict(image_dimension=hw, **CONFIGS[name], **extra)
    return (DataConfig(native_assemble=True, **kw),
            DataConfig(native_assemble=False, **kw),
            JaxDataConfig(native_assemble=False, **kw))


def frame_arrays(rng, fdtype, mdtype, hw=HW):
    """The arrays of ``tests/test_native.py`` TestAssembleKernels: dense
    random sources with a NaN in the radar and one in the GT."""
    h, w = hw
    a = {
        "image": rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
        "gt": rng.uniform(-5, 150, (h, w, 3)).astype(fdtype),
        "mseg": rng.integers(0, 21, (h + 8, w)).astype(mdtype),
        "radar": rng.uniform(-5, 150, (h, w, 3)).astype(fdtype),
        "rad_vel": rng.uniform(0, 1, (h, w)).astype(fdtype),
        "im_uv": rng.normal(0, 1, (h, w, 2)).astype(fdtype),
        "radar_filtered": rng.uniform(-5, 150, (h, w)).astype(fdtype),
    }
    a["radar"][0, 0, 0] = np.nan
    a["gt"][0, 1, 0] = np.nan
    return a


def wire_arrays(rng, fdtype, mdtype, hw=HW):
    """The arrays of ``tests/test_native.py`` TestWireEncodeNative: sparse
    radar with a uv-only point, a NaN point and a -0.0 that is no point;
    30 %-dense GT with d == max_depth, a negative and a NaN."""
    h, w = hw
    radar = np.zeros((h, w, 3), fdtype)
    ys = rng.integers(0, h, 70)
    xs = rng.integers(0, w, 70)
    radar[ys, xs, 0] = rng.uniform(-5, 150, 70)
    radar[ys, xs, 1] = rng.normal(0, 1, 70)
    radar[ys, xs, 2] = rng.normal(0, 1, 70)
    radar[0, 0] = (0.0, 0.4, -0.3)
    radar[0, 1, 0] = np.nan
    radar[0, 2, 0] = -0.0
    rad_vel = np.zeros((h, w), fdtype)
    rad_vel[1, 1] = 1.0
    gt = np.zeros((h, w, 3), fdtype)
    m = rng.random((h, w)) < 0.3
    gt[..., 0][m] = rng.uniform(0.5, 150, int(m.sum()))
    gt[2, 2, 0] = 100.0
    gt[2, 3, 0] = -1.0
    gt[2, 4, 0] = np.nan
    mseg = rng.integers(0, 21, (h + 8, w)).astype(mdtype)
    mseg[0] = 255
    rf = np.zeros((h, w), fdtype)
    rf[ys, xs] = rng.uniform(-5, 150, 70)
    return {"image": rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
            "radar": radar, "rad_vel": rad_vel, "gt": gt, "mseg": mseg,
            "radar_filtered": rf}


def assert_same(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def counted(fn, *args):
    """(fn(*args), the native counts that the call added)."""
    native.reset_counts()
    out = fn(*args)
    return out, {k: v for k, v in native.counts.items() if v}


@pytest.mark.parametrize("mdtype", [np.int64, np.int32, np.uint8])
@pytest.mark.parametrize("fdtype", [np.float32, np.float64])
def test_assemble_native_matches_numpy_and_jax(fdtype, mdtype):
    arrays = frame_arrays(np.random.default_rng(0), fdtype, mdtype)
    for name in CONFIGS:
        nat_cfg, np_cfg, jax_cfg = cfgs(name)
        got, n = counted(channels.assemble_frame, arrays, nat_cfg)
        assert n == {"assemble_native": 1}, (name, n)
        ours, n = counted(channels.assemble_frame, arrays, np_cfg)
        assert n == {"assemble_numpy": 1}, (name, n)
        want = jax_channels.assemble_frame(arrays, jax_cfg)
        what = f"{name} {np.dtype(fdtype)} {np.dtype(mdtype)}"
        assert_same(ours, want, what)
        assert_same(got, want, what)


@pytest.mark.parametrize("fdtype", [np.float32, np.float64])
@pytest.mark.parametrize("gt_cap", [4096, 0])
def test_wire_native_matches_numpy_and_jax(gt_cap, fdtype):
    rng = np.random.default_rng(3)
    for mdtype in (np.int64, np.int32):
        arrays = wire_arrays(rng, fdtype, mdtype)
        for name in WIRE_CONFIGS:
            nat_cfg, np_cfg, jax_cfg = cfgs(name)
            n_ch = wire.radar_channel_count(nat_cfg)
            plan = wire.WirePlan(radar_cap=256, gt_cap=gt_cap,
                                 n_radar_ch=n_ch)
            jplan = jax_wire.WirePlan(radar_cap=256, gt_cap=gt_cap,
                                      n_radar_ch=n_ch)
            got, n = counted(wire.encode_frame_wire, arrays, nat_cfg, plan)
            assert n == {"wire_native": 1}, (name, n)
            ours = wire.encode_frame_wire(arrays, np_cfg, plan)
            want = jax_wire.encode_frame_wire(arrays, jax_cfg, jplan)
            what = f"{name} {np.dtype(fdtype)} {np.dtype(mdtype)} {gt_cap}"
            assert_same(ours, want, what)
            assert_same(got, want, what)


def test_full_size_frame_native_matches_numpy():
    """One 416x800 frame, dense and wire, as the loader gives it on the
    card's main path."""
    hw = (416, 800)
    rng = np.random.default_rng(5)
    arrays = frame_arrays(rng, np.float32, np.int64, hw)
    nat_cfg, np_cfg, _ = cfgs("base", hw)
    assert_same(channels.assemble_frame(arrays, nat_cfg),
                channels.assemble_frame(arrays, np_cfg), "dense 416x800")
    arrays = wire_arrays(rng, np.float32, np.int64, hw)
    plan = wire.WirePlan(radar_cap=256, gt_cap=110592, n_radar_ch=4)
    got, n = counted(wire.encode_frame_wire, arrays, nat_cfg, plan)
    assert n == {"wire_native": 1}
    assert_same(got, wire.encode_frame_wire(arrays, np_cfg, plan),
                "wire 416x800")


@pytest.mark.parametrize("gt_cap,what", [(4096, "radar channels"),
                                         (64, "lidar GT")])
def test_wire_overflow_texts(gt_cap, what):
    arrays = wire_arrays(np.random.default_rng(4), np.float32, np.int64)
    radar_cap = 8 if what == "radar channels" else 256
    texts = []
    for cfg in cfgs("base")[:2]:
        plan = wire.WirePlan(radar_cap=radar_cap, gt_cap=gt_cap,
                             n_radar_ch=4)
        with pytest.raises(wire.WireOverflowError) as e:
            wire.encode_frame_wire(arrays, cfg, plan)
        texts.append(str(e.value))
    jplan = jax_wire.WirePlan(radar_cap=radar_cap, gt_cap=gt_cap,
                              n_radar_ch=4)
    with pytest.raises(jax_wire.WireOverflowError) as e:
        jax_wire.encode_frame_wire(arrays, cfgs("base")[2], jplan)
    assert texts == [str(e.value)] * 2
    assert texts[0].startswith(f"{what}: ")


def test_wire_out_of_range_seg_leaves_the_native_path():
    arrays = wire_arrays(np.random.default_rng(5), np.float32, np.int64)
    arrays["mseg"][5, 5] = 1000
    plan = wire.WirePlan(radar_cap=256, gt_cap=0, n_radar_ch=4)
    texts = []
    for cfg in cfgs("base")[:2]:
        native.reset_counts()
        with pytest.raises(ValueError, match="uint8 range") as e:
            wire.encode_frame_wire(arrays, cfg, plan)
        texts.append(str(e.value))
        assert native.counts["wire_numpy"] == 1
    assert texts[0] == texts[1]


def _fp16_radar(a):
    a["radar"] = a["radar"].astype(np.float16)


def _fortran_radar(a):
    a["radar"] = np.asfortranarray(a["radar"])


def _tall_gt(a):
    a["gt"] = np.concatenate([a["gt"], a["gt"][:2]])


@pytest.mark.parametrize("plant", [_fp16_radar, _fortran_radar, _tall_gt])
def test_uncovered_frames_take_numpy(plant):
    arrays = frame_arrays(np.random.default_rng(1), np.float32, np.int64)
    plant(arrays)
    nat_cfg, np_cfg, jax_cfg = cfgs("base")
    got, n = counted(channels.assemble_frame, arrays, nat_cfg)
    assert n == {"assemble_numpy": 1}
    assert_same(got, jax_channels.assemble_frame(arrays, jax_cfg), "dense")
    warrays = wire_arrays(np.random.default_rng(1), np.float32, np.int64)
    plant(warrays)
    plan = wire.WirePlan(radar_cap=256, gt_cap=4096, n_radar_ch=4)
    got, n = counted(wire.encode_frame_wire, warrays, nat_cfg, plan)
    assert n == {"wire_numpy": 1}
    assert_same(got, wire.encode_frame_wire(warrays, np_cfg, plan), "wire")


def test_sparse_lidar_takes_numpy():
    arrays = frame_arrays(np.random.default_rng(2), np.float32, np.int64)
    nat_cfg, _, jax_cfg = cfgs("base", sparse_lidar=True)
    got, n = counted(channels.assemble_frame, arrays, nat_cfg,
                     np.random.default_rng(7))
    assert n == {"assemble_numpy": 1}
    want = jax_channels.assemble_frame(arrays, jax_cfg,
                                       rng=np.random.default_rng(7))
    assert_same(got, want, "sparse_lidar")


def test_default_config_routes_native():
    cfg = DataConfig(image_dimension=HW)
    assert cfg.native_assemble
    arrays = frame_arrays(np.random.default_rng(2), np.float32, np.int64)
    out, n = counted(channels.assemble_frame, arrays, cfg)
    assert n == {"assemble_native": 1}
    assert out["features"].shape == HW + (7,)
    plan = wire.WirePlan(radar_cap=256, gt_cap=4096, n_radar_ch=4)
    warrays = wire_arrays(np.random.default_rng(2), np.float32, np.int64)
    _, n = counted(wire.encode_frame_wire, warrays, cfg, plan)
    assert n == {"wire_native": 1}


@pytest.mark.parametrize("broken", ["missing", "failing"])
def test_failed_build_raises(monkeypatch, tmp_path, broken):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    if broken == "missing":
        monkeypatch.setattr(native, "GXX", str(tmp_path / "no-such-g++"))
        reason = "no-such-g++"
    else:
        monkeypatch.setattr(native, "GXX_FLAGS",
                            native.GXX_FLAGS + ("-fno-such-option",))
        reason = "-fno-such-option"
    arrays = frame_arrays(np.random.default_rng(6), np.float32, np.int64)
    nat_cfg, np_cfg, _ = cfgs("base")
    with pytest.raises(native.NativeCompileError) as e:
        channels.assemble_frame(arrays, nat_cfg)
    assert reason in str(e.value)
    assert "data.native_assemble=false" in str(e.value)
    assert native._lib is None and not list(tmp_path.rglob("*.so"))
    # numpy needs no build
    channels.assemble_frame(arrays, np_cfg)


def test_threads_share_one_build(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    barrier = threading.Barrier(2)
    libs = []

    def first_use():
        barrier.wait()
        libs.append(native.library())

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(libs) == 2 and libs[0] is libs[1]
    assert [p.name for p in tmp_path.rglob("*") if p.is_file()] == [
        "libcamradepth_host.so"]
    assert native.build_info["seconds"] > 0
