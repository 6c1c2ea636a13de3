"""The port's GELU (camradepth_tpu_torch.ops.gelu) against the JAX
package's ``gelu_for_dtype``, on the CPU.

bf16: over every finite bf16 bit pattern the port equals JAX bit for bit
wherever |x| >= 1e-30. Below that XLA flushes subnormal inputs to zero
while torch keeps them, so the outputs there differ by under 1.2e-38.
fp32: both take the exact erf form; they differ only by the last bits of
two erf implementations (rtol 1e-6, atol 1e-6).

On the CPU the wrapper runs the plain version; the card's elementwise
kernel is held against it bit for bit in tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camradepth_tpu.models.layers import gelu_for_dtype as jax_gelu
from camradepth_tpu_torch.models.layers import gelu_for_dtype
from camradepth_tpu_torch.ops import _build
from camradepth_tpu_torch.ops.gelu import (
    BF16_SQRT_2_OVER_PI,
    TABLE_FIELDS,
    gelu_bf16,
    gelu_bf16_reference,
    gelu_bf16_tanh_term,
)
from tests.torch_port import one_torch_thread  # noqa: F401


def test_bf16_gelu_matches_jax_bit_for_bit():
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    xf = x.float().numpy()
    got = gelu_for_dtype(x).float().numpy()
    want = np.asarray(jax.jit(jax_gelu)(jnp.asarray(bits.view(jnp.bfloat16)))
                      .astype(jnp.float32))
    finite = np.isfinite(xf)
    normal = finite & (np.abs(xf) >= 1e-30)
    assert normal.sum() > 58000
    np.testing.assert_array_equal(got[normal], want[normal])
    tiny = finite & ~normal
    assert np.abs(got[tiny] - want[tiny]).max() < 1.2e-38


def test_bf16_gelu_table_shortcuts_hold_for_every_input():
    """The kernels tabulate bf16 GELU only for exponent fields 118 to 128
    (csrc/gelu_bf16.cuh); below, the result is x * 0.5 rounded, above (and
    finite) x for x > 0 and -0 for x < 0. Checked on every bf16 input."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    y = gelu_bf16_reference(x).view(torch.int16).numpy().view(np.uint16)
    field = (bits >> 7) & 0xFF
    low = field < 118
    half = (x.float() * 0.5).to(torch.bfloat16)
    np.testing.assert_array_equal(
        y[low], half.view(torch.int16).numpy().view(np.uint16)[low])
    high = (field >= 129) & (field < 255)
    positive = high & (bits < 0x8000)
    np.testing.assert_array_equal(y[positive], bits[positive])
    assert (y[high & ~positive] == 0x8000).all()


def test_bf16_gelu_vjp_table_shortcuts_hold_for_every_input():
    """The VJP kernel reads its term i = tanh(h) from a table only for the
    exponent fields TABLE_FIELDS (csrc/gelu_bf16.cu), and only for x > 0:
    i is odd in x, bit for bit. Below the fields, i is 0.796875 * x
    rounded, above (and finite) +1 for x > 0 and -1 for x < 0, bit for
    bit. Its other x-only terms it computes from i and x with the plain
    version's operations. Checked on every bf16 input."""
    lo, hi = TABLE_FIELDS
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)

    def u16(t):
        return t.view(torch.int16).numpy().view(np.uint16)

    i = u16(gelu_bf16_tanh_term(x))
    field = (bits >> 7) & 0xFF
    # odd: -x (the sign bit flipped) gives -i, NaN aside
    flipped = u16(gelu_bf16_tanh_term(-x))
    number = field < 255
    np.testing.assert_array_equal(flipped[number], (i ^ 0x8000)[number])
    low = field < lo
    np.testing.assert_array_equal(i[low], u16(x * BF16_SQRT_2_OVER_PI)[low])
    high = (field >= hi) & (field < 255)
    sign = np.where(bits >= 0x8000, 0xBF80, 0x3F80).astype(np.uint16)
    np.testing.assert_array_equal(i[high], sign[high])
    # the table is needed: from field 123 up to its last field some inputs
    # take neither shortcut (below 123 the first holds; the table shares
    # the forward's fields)
    inside = (field >= lo) & (field < hi)
    differs = (i != u16(x * BF16_SQRT_2_OVER_PI)) & (i != sign)
    assert set(field[inside & differs]) == set(range(123, hi))


def test_fp32_gelu_matches_jax():
    x = (4 * np.random.default_rng(0).standard_normal(20000)).astype(
        np.float32)
    got = gelu_for_dtype(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax_gelu)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_cpu_gelu_never_touches_the_kernel_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU call reached the CUDA build")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    before = gelu_bf16.launches
    y = gelu_bf16(torch.ones(3, 5, dtype=torch.bfloat16))
    assert y.shape == (3, 5) and y.dtype == torch.bfloat16
    assert gelu_bf16.launches == before
    with pytest.raises(TypeError, match="bf16"):
        gelu_bf16(torch.ones(2))
