"""The port's geometry (``geometry/se3.py``, ``geometry/raster.py``) against
the JAX package's on the same numpy-seeded inputs, on the CPU.

se3 in float64 to 1e-12 (numpy and torch inputs alike); the raster bit for
bit with JAX's sort-based scatter (which ``tests/test_geometry.py`` holds to
the reference's z-buffer loop), ties included, on fp32 inputs (JAX's
default float).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from camradepth_tpu.geometry import raster as jax_raster
from camradepth_tpu.geometry import se3 as jax_se3
from camradepth_tpu_torch.geometry import raster, se3
from tests.torch_port import one_torch_thread  # noqa: F401

K = np.array([[1266.0, 0, 816.0], [0, 1266.0, 491.0], [0, 0, 1]])


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_se3_matches_jax_float64(kind):
    rng = np.random.default_rng(0)
    q, q1 = rng.standard_normal(4), rng.standard_normal(4)
    t = rng.standard_normal(3)
    np.testing.assert_allclose(se3.quat_to_rot(q), jax_se3.quat_to_rot(q),
                               atol=1e-12)
    for inv in (False, True):
        np.testing.assert_allclose(se3.transform_matrix(t, q, inv),
                                   jax_se3.transform_matrix(t, q, inv),
                                   atol=1e-12)
    for amount in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(se3.quat_slerp(q, q1, amount),
                                   jax_se3.quat_slerp(q, q1, amount),
                                   atol=1e-12)
    np.testing.assert_allclose(se3.quat_slerp(q, q * 1.0001, 0.5),
                               jax_se3.quat_slerp(q, q * 1.0001, 0.5),
                               atol=1e-12)
    tm = se3.compose(se3.transform_matrix(t, q),
                     se3.transform_matrix(-t, q1, True))
    np.testing.assert_allclose(tm, jax_se3.compose(
        jax_se3.transform_matrix(t, q), jax_se3.transform_matrix(-t, q1,
                                                                 True)),
        atol=1e-12)

    pts = rng.standard_normal((50, 3)) * 10
    pts[:, 2] = np.abs(pts[:, 2]) + 1
    pts[3, 2] = 0.0  # the z == 0 guard
    vx, vy = rng.standard_normal(50), rng.standard_normal(50)
    flow = rng.standard_normal((8, 12, 2))
    mask = rng.random((8, 12)) < 0.5
    conv = ((lambda a: torch.from_numpy(np.asarray(a)))
            if kind == "torch" else np.asarray)
    back = lambda a: a.numpy() if torch.is_tensor(a) else np.asarray(a)

    got = se3.apply_se3(tm, conv(pts))
    assert torch.is_tensor(got) == (kind == "torch")
    np.testing.assert_allclose(back(got), jax_se3.apply_se3(tm, pts),
                               atol=1e-12)
    np.testing.assert_allclose(
        back(se3.doppler_compensate(conv(pts), conv(vx), conv(vy), 0.35)),
        jax_se3.doppler_compensate(pts, vx, vy, 0.35), atol=1e-12)
    for a, b in zip(se3.project_pinhole(conv(pts), K),
                    jax_se3.project_pinhole(pts, K)):
        np.testing.assert_allclose(back(a), b, atol=1e-12)
    x, y = jax_se3.project_pinhole(pts, K)
    np.testing.assert_array_equal(
        back(se3.fov_mask(conv(x), conv(y), conv(pts[:, 2]))),
        jax_se3.fov_mask(x, y, pts[:, 2]))
    for m in (None, mask):
        np.testing.assert_allclose(
            back(se3.flow_to_uv(conv(flow), K, None if m is None
                                else conv(m), 2, 3)),
            jax_se3.flow_to_uv(flow, K, m, 2, 3), atol=1e-12)


def _raster_inputs(seed, n, h, w, ties=True):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    x, y = f32(rng.uniform(0, w - 1, n)), f32(rng.uniform(0, h - 1, n))
    depth = f32(rng.uniform(2, 100, n))
    if ties:
        # equal depths on shared pixels, the first point must win
        x[n // 2:n // 2 + 20] = x[:20]
        y[n // 2:n // 2 + 20] = y[:20]
        depth[n // 2:n // 2 + 20] = depth[:20]
    return rng, x, y, depth


def test_raster_min_depth_matches_jax_bit_for_bit():
    n, h, w, scale = 600, 90, 160, 2.0
    rng, x, y, depth = _raster_inputs(2, n, h, w)
    rcs = np.asarray(rng.uniform(-5, 20, n), np.float32)
    tag = np.arange(n, dtype=np.float32)
    uv = np.asarray(rng.standard_normal((n, 2)), np.float32)
    valid = rng.random(n) < 0.9
    h_out, w_out = int(h / scale), int(w / scale)
    j = jax_raster.quantize_points(jnp.asarray(x), jnp.asarray(y), h_out,
                                   w_out, scale)
    t = raster.quantize_points(torch.from_numpy(x), torch.from_numpy(y),
                               h_out, w_out, scale)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pix = j[1] * w_out + j[0]
    for v in (None, valid):
        jd, jp = jax_raster.raster_min_depth(
            pix, jnp.asarray(depth), {"rcs": jnp.asarray(rcs),
                                      "tag": jnp.asarray(tag),
                                      "uv": jnp.asarray(uv)},
            h_out * w_out, None if v is None else jnp.asarray(v))
        td, tp = raster.raster_min_depth(
            torch.from_numpy(np.array(pix)), torch.from_numpy(depth),
            {"rcs": torch.from_numpy(rcs), "tag": torch.from_numpy(tag),
             "uv": torch.from_numpy(uv)},
            h_out * w_out, None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        for k in jp:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    # the ties resolved to the first point, as the reference's loop does
    first = tp["tag"].numpy()[np.asarray(pix)[:20]]
    assert (first < n // 2).all()
    assert (td.numpy() > 0).sum() == (np.asarray(jd) > 0).sum() > 100


def test_raster_cases_of_the_jax_tests():
    pix = torch.tensor([0, 1, 2], dtype=torch.int32)
    dm, _ = raster.raster_min_depth(pix, torch.tensor([5.0, 3.0, 1.0]), {}, 4,
                                    torch.tensor([True, False, True]))
    assert dm.tolist() == [5.0, 0.0, 1.0, 0.0]
    _, pm = raster.raster_min_depth(torch.tensor([3, 3]),
                                    torch.tensor([7.0, 7.0]),
                                    {"tag": torch.tensor([1.0, 2.0])}, 4)
    assert float(pm["tag"][3]) == 1.0
    dm, _ = raster.raster_min_depth(torch.zeros(0, dtype=torch.int32),
                                    torch.zeros(0), {}, 4)
    assert dm.tolist() == [0.0] * 4


def test_rasterize_radar_matches_jax_bit_for_bit():
    n = 512
    rng, x1, y1, depth = _raster_inputs(3, n, 899, 1599)
    f32 = lambda a: np.asarray(a, np.float32)
    args = dict(depth1=depth, times1=f32(rng.uniform(0, 0.5, n)),
                x2=f32(x1 + rng.uniform(-3, 3, n)),
                y2=f32(y1 + rng.uniform(-3, 3, n)),
                rcs=f32(rng.uniform(-5, 10, n)),
                v_comp=f32(rng.uniform(0, 2, n)),
                valid=rng.random(n) < 0.95)
    want = jax_raster.rasterize_radar(jnp.asarray(x1), jnp.asarray(y1),
                                      **{k: jnp.asarray(v)
                                         for k, v in args.items()})
    got = raster.rasterize_radar(torch.from_numpy(x1), torch.from_numpy(y1),
                                 **{k: torch.from_numpy(v)
                                    for k, v in args.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == tuple(want[k].shape), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert (got["depth"] > 0).sum() > 300
