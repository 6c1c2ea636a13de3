"""The port's fused 3x3 conv + GroupNorm statistics
(camradepth_tpu_torch.ops.conv_fused) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. On the
CPU the port's ``conv3x3_fused`` runs its plain version; the Hopper kernel
is held against that plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances:
- fp32, against ``conv3x3_reference``: the JAX package's own limits
  (tests/test_conv_fused.py:38-45): raw atol 2e-5, rtol 1e-4; sums rtol
  1e-4, atol 1e-3 (both sum in fp32, in other orders).
- bf16, against the Pallas kernel in interpret mode, first N channels. The
  affine on load rounds alike in both (multiply, then add, in bf16), and
  GELU too: the port evaluates JAX's bf16 tanh form operation by operation
  (ops/gelu.py). So with GELU and without it the raw outputs agree to 1
  bf16 ulp (taken at no less than 2**-10 of the output's RMS) and the sums
  to rtol 1e-4, atol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camradepth_tpu.ops import conv_fused as J
from camradepth_tpu_torch.ops import _build
from camradepth_tpu_torch.ops.attention import maxpool_attention_scores
from camradepth_tpu_torch.ops.conv_fused import (
    Source,
    conv3x3_fused,
    gn_affine_from_stats,
)
from camradepth_tpu_torch.ops.resize import upsample_bicubic_x2
from tests.torch_port import one_torch_thread  # noqa: F401


def _case(name, seed=0):
    """numpy sources [(x, scale, shift, gelu, valid)] and HWIO weights."""
    rng = np.random.default_rng(seed)

    def randn(*shape, s=1.0, m=0.0):
        return (m + s * rng.standard_normal(shape)).astype(np.float32)

    if name == "multi_source":  # tests/test_conv_fused.py:27-35
        y1 = randn(2, 16, 32, 128)
        y1[..., 96:] = 0
        srcs = [(randn(2, 16, 32, 128), None, None, False, None),
                (randn(2, 16, 32, 8), None, None, False, None),
                (y1, randn(2, 96, s=0.2, m=1.0), randn(2, 96, s=0.1), True,
                 96)]
        k, n = 128 + 8 + 96, 64
    elif name == "single":
        srcs = [(randn(1, 8, 8, 16), None, None, False, None)]
        k, n = 16, 24
    elif name == "ragged":  # odd H and W, K and N off every tile
        srcs = [(randn(2, 7, 11, 5), None, None, True, None),
                (randn(2, 7, 11, 9), randn(2, 9, s=0.2, m=1.0),
                 randn(2, 9, s=0.1), True, None)]
        k, n = 14, 13
    else:
        raise ValueError(name)
    return srcs, randn(3, 3, k, n, s=0.1)


def _jax_sources(srcs, dtype):
    return [J.Source(jnp.asarray(x, dtype),
                     None if sc is None else jnp.asarray(sc),
                     None if sh is None else jnp.asarray(sh), g, v)
            for x, sc, sh, g, v in srcs]


def _torch_sources(srcs, dtype):
    t = torch.from_numpy
    return [Source(t(x).to(dtype), None if sc is None else t(sc),
                   None if sh is None else t(sh), g, v)
            for x, sc, sh, g, v in srcs]


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("name", ["multi_source", "single", "ragged"])
def test_plain_matches_jax_reference_fp32(name):
    srcs, w = _case(name)
    want = J.conv3x3_reference(_jax_sources(srcs, jnp.float32),
                               jnp.asarray(w))
    got = conv3x3_fused(_torch_sources(srcs, torch.float32),
                        torch.from_numpy(w))
    assert got[0].shape == want[0].shape and got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), rtol=1e-4,
                               atol=2e-5)
    for g, wnt in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), _np(wnt), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("gelu", [True, False])
def test_plain_matches_jax_pallas_interpret_bf16(gelu):
    srcs, w = _case("multi_source")
    x, sc, sh, _, valid = srcs[2]
    srcs[2] = (x, sc, sh, gelu, valid)
    want = J.conv3x3_fused(_jax_sources(srcs, jnp.bfloat16), jnp.asarray(w),
                           interpret=True)
    got = conv3x3_fused(_torch_sources(srcs, torch.bfloat16),
                        torch.from_numpy(w))
    n = w.shape[-1]
    assert want[0].shape[-1] == 128 and got[0].shape[-1] == n  # no padding
    assert got[0].dtype == torch.bfloat16
    g, wnt = got[0].float().numpy(), _np(want[0])[..., :n]
    rms = float(np.sqrt(np.mean(wnt**2)))
    ulp = 2.0**-7 * np.exp2(np.floor(np.log2(np.maximum(
        np.maximum(np.abs(g), np.abs(wnt)), 2.0**-10 * rms))))
    assert (np.abs(g - wnt) <= ulp).all()
    for g, wnt in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), _np(wnt), rtol=1e-4, atol=1e-3)


def test_gn_affine_from_stats_matches_jax():
    rng = np.random.default_rng(1)
    s = rng.standard_normal((2, 32)).astype(np.float32) * 50
    q = (np.abs(rng.standard_normal((2, 32))) * 400 + s**2 / 64).astype(
        np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(32)).astype(np.float32)
    want = J.gn_affine_from_stats(jnp.asarray(s), jnp.asarray(q), 64,
                                  jnp.asarray(gamma), jnp.asarray(beta), 2)
    got = gn_affine_from_stats(*(torch.from_numpy(a) for a in (s, q)), 64,
                               torch.from_numpy(gamma),
                               torch.from_numpy(beta), 2)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (2, 32)
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-5)


def test_cpu_tensors_never_touch_the_kernel_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU call reached the CUDA build")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    before = conv3x3_fused.launches
    srcs, w = _case("ragged")
    raw, s, q = conv3x3_fused(_torch_sources(srcs, torch.float32),
                              torch.from_numpy(w))
    assert raw.shape == (2, 7, 11, 13) and s.shape == q.shape == (2, 13)
    assert conv3x3_fused.launches == before


@pytest.mark.parametrize("call", ["attention", "upsample", "conv"])
def test_cpu_paths_stay_differentiable(call):
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 4, 6, 8)).astype(np.float32)).requires_grad_()
    if call == "attention":
        out = maxpool_attention_scores(x.reshape(1, 24, 8),
                                       x.reshape(1, 24, 8), 2, 0.5)
    elif call == "upsample":
        out = upsample_bicubic_x2(x)
    else:
        out = conv3x3_fused([Source(x, gelu=True)],
                            torch.ones(3, 3, 8, 4))[0]
    out.square().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert x.grad.abs().sum() > 0


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError, match="HWIO"):
        conv3x3_fused([Source(x)], torch.zeros(3, 3, 4, 2))
    with pytest.raises(ValueError, match="need 1 to 4 sources"):
        conv3x3_fused([], torch.zeros(3, 3, 3, 2))
