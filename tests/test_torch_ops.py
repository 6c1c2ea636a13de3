"""The port's ops (camradepth_tpu_torch.ops, models.layers.gelu_for_dtype)
against the JAX package on the same numpy-seeded inputs, on the CPU.

On a CPU tensor each kernel wrapper runs its plain PyTorch version, so
these tests hold the arithmetic every Hopper kernel mirrors against the
JAX functions. Tolerances:
- fp32: those of tests/test_ops.py (1e-5) and tests/test_resize_pallas.py:29
  (atol 2e-6, rtol 1e-5); sums are taken in another order in the two
  frameworks.
- bf16: one bf16 ulp (2**-7 relative) where both sides round at the same
  places, two where XLA evaluates an elementwise chain in fp32 and torch
  rounds after every op (GELU's tanh form).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from camradepth_tpu.ops import attention as jattn
from camradepth_tpu.ops.groupnorm import group_norm as jax_group_norm
from camradepth_tpu.ops.resize import upsample_bicubic_x2 as jax_upsample
from camradepth_tpu.ops.resize_pallas import _upsample_pallas_4d
from camradepth_tpu_torch.models.layers import gelu_for_dtype
from camradepth_tpu_torch.ops.attention import (
    maxpool_attention,
    maxpool_attention_scores,
    maxpool_attention_scores_reference,
)
from camradepth_tpu_torch.ops.groupnorm import group_norm
from camradepth_tpu_torch.ops.resize import (
    SMEM_MAX,
    upsample_bicubic_x2,
    upsample_bicubic_x2_reference,
    upsample_plan,
)
from tests.torch_port import one_torch_thread  # noqa: F401

BF16_ULP = 2.0 ** -7
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(
        jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,groups", [((2, 6, 10, 64), 4),
                                          ((3, 37, 32), 2),
                                          ((1, 5, 7, 48), 48)])
def test_group_norm_matches_jax(dtype, shape, groups):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal(shape) + 1.0).astype(np.float32)
    c = shape[-1]
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    want = _np(jax_group_norm(jnp.asarray(x, jdt), jnp.asarray(scale),
                              jnp.asarray(bias), groups))
    got = group_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
                     torch.from_numpy(bias), groups)
    assert got.dtype == tdt and got.shape == shape
    tol = 1e-5 if dtype == "float32" else BF16_ULP
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gelu_for_dtype_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    want = _np(fnn.gelu(jnp.asarray(x, jdt),
                        approximate=(dtype == "bfloat16")))
    got = gelu_for_dtype(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=2 * BF16_ULP,
                                   atol=2 * BF16_ULP)


UPSAMPLE_SHAPES = [(1, 8, 16, 128), (2, 13, 25, 129), (1, 7, 9, 3),
                   (2, 1, 5, 2)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", UPSAMPLE_SHAPES)
def test_upsample_matches_jax(dtype, shape):
    """Both sides accumulate each axis in fp32 and round to the I/O dtype
    between the axes, so bf16 agrees to one ulp."""
    tdt, jdt = DTYPES[dtype]
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = _np(jax_upsample(jnp.asarray(x, jdt)))
    got = upsample_bicubic_x2(torch.from_numpy(x).to(tdt))
    b, h, w, c = shape
    assert got.shape == (b, 2 * h, 2 * w, c) and got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=2e-6)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=BF16_ULP,
                                   atol=BF16_ULP)


def test_upsample_matches_pallas_interpret():
    """The TPU kernel itself, run in interpret mode as
    tests/test_resize_pallas.py:25-29 runs it."""
    x = np.random.default_rng(2).standard_normal((1, 8, 16, 128)).astype(
        np.float32)
    want = np.asarray(_upsample_pallas_4d(jnp.asarray(x), interpret=True))
    got = upsample_bicubic_x2_reference(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("shape", UPSAMPLE_SHAPES)
def test_upsample_matches_torch_interpolate(shape):
    """PyTorch's own bicubic (fp32 yardstick; never called by the port)."""
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(x)
    want = F.interpolate(xt.permute(0, 3, 1, 2), scale_factor=2,
                         mode="bicubic", align_corners=False)
    got = upsample_bicubic_x2(xt)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-5, atol=1e-5)


# the five decoder inputs of base at 416x800, batch 8, then ragged ones:
# C = 1, 3, 129, 257, 513, H = 1, W = 1, a ragged last W span, B = 3
PLAN_SHAPES = [(8, 13, 25, 256), (8, 26, 50, 128), (8, 52, 100, 128),
               (8, 104, 200, 129), (8, 208, 400, 129), (2, 5, 7, 1),
               (3, 7, 9, 3), (2, 7, 9, 129), (1, 4, 6, 257), (1, 3, 5, 513),
               (2, 1, 37, 16), (2, 23, 1, 24), (1, 1, 1, 5), (1, 9, 61, 129),
               (1, 3, 1001, 8)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_upsample_plan_covers_every_output_once(shape, itemsize):
    """The blocks of csrc/upsample_bicubic_x2.cu's launch: each writes the
    2x2 outputs of its input rows and columns; together they write every
    output exactly once, in the shared memory a block may have."""
    b, h, w, c = shape
    plan = upsample_plan(b, h, w, c, itemsize, 132)
    assert plan.smem <= SMEM_MAX
    spans, strips, nb = plan.grid
    assert nb == b and spans == -(-w // plan.tw)
    assert strips == -(-h // plan.rows)
    count = np.zeros((2 * h, 2 * w), np.int32)
    for sy in range(strips):
        for sx in range(spans):
            rows = slice(2 * sy * plan.rows, 2 * min((sy + 1) * plan.rows, h))
            cols = slice(2 * sx * plan.tw, 2 * min((sx + 1) * plan.tw, w))
            count[rows, cols] += 1
    assert (count == 1).all()
    if shape[0] == 8:  # the decoder's launches fill the card
        assert spans * strips * nb >= 2 * 132


def test_upsample_plan_keeps_decoder_spans_in_registers():
    """At the decoder's widths a block's H span, its 2-column halo on each
    side and the 16-byte slack fit the kernel's 256 threads x 2 vectors."""
    for itemsize in (2, 4):
        n = 16 // itemsize
        for b, h, w, c in PLAN_SHAPES[:5]:
            plan = upsample_plan(b, h, w, c, itemsize, 132)
            assert (plan.tw + 4) * c + 2 * n <= 2 * 256 * n


def test_upsample_plan_refuses_what_shared_memory_cannot_hold():
    assert upsample_plan(1, 8, 8, 4148, 4, 132).smem <= SMEM_MAX
    assert upsample_plan(1, 8, 8, 4838, 2, 132).smem <= SMEM_MAX
    for c, itemsize in ((4149, 4), (4839, 2)):
        with pytest.raises(ValueError, match="shared memory"):
            upsample_plan(1, 8, 8, c, itemsize, 132)
    with pytest.raises(ValueError, match="empty"):
        upsample_plan(1, 0, 8, 3, 2, 132)


ATTN_CASES = [(1, 13, 16), (2, 7, 32), (4, 21, 160), (8, 5, 64),
              (8, 33, 256)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("heads,m,c", ATTN_CASES)
def test_attention_scores_match_jax(dtype, heads, m, c):
    """The XLA function is the contract the Pallas kernel mirrors (the
    Pallas kernel has no interpret path). bf16 inputs: both sides take
    exact products in fp32, so only the summation order differs."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 41, c)).astype(np.float32)
    k = rng.standard_normal((2, m, c)).astype(np.float32)
    scale = (c // heads) ** -0.5
    want = np.asarray(jattn.maxpool_attention_scores(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), heads, scale))
    got = maxpool_attention_scores(torch.from_numpy(q).to(tdt),
                                   torch.from_numpy(k).to(tdt), heads, scale)
    assert got.dtype == torch.float32 and got.shape == (2, 41)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("heads,m,c", ATTN_CASES)
def test_maxpool_attention_matches_jax(dtype, heads, m, c):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    x, q = (rng.standard_normal((2, 41, c)).astype(np.float32)
            for _ in range(2))
    k = rng.standard_normal((2, m, c)).astype(np.float32)
    scale = (c // heads) ** -0.5
    want = _np(jattn.maxpool_attention(
        jnp.asarray(x, jdt), jnp.asarray(q, jdt), jnp.asarray(k, jdt),
        heads, scale))
    got = maxpool_attention(*(torch.from_numpy(a).to(tdt) for a in (x, q, k)),
                            heads, scale)
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else BF16_ULP
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)


def test_attention_reference_is_the_wrapper_on_cpu():
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((1, 9, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 4, 64)).astype(np.float32))
    torch.testing.assert_close(
        maxpool_attention_scores(q, k, 2, 0.125),
        maxpool_attention_scores_reference(q, k, 2, 0.125),
        rtol=0, atol=0)
