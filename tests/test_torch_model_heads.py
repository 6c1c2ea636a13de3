"""The port's seg head, TPUDecoder stage and subpixel depth head against the
flax modules of the JAX package, on the CPU (beside
tests/test_torch_model.py; a file of 8 or fewer tests queues behind the
suite's longest file under ``--dist loadfile``): fp32 to 1e-4; bf16 at
most 1.5 times the JAX module's own bf16-vs-fp32 error, in mean and in max
(``_bf16_rule``, tests/test_torch_model.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camradepth_tpu.models import layers as jlay
from camradepth_tpu_torch.models import layers as tlay
from tests.test_torch_model import _bf16_rule, _carry, _jax_init, _rand
from tests.torch_port import one_torch_thread  # noqa: F401


def _module_vs_flax(make_jax, port, args, dtype, head=None):
    """A flax module (``make_jax(dtype)``) and the port's counterpart on
    the same numpy-seeded parameters and inputs ``args``, held in fp32 to
    1e-4 and in bf16 by :func:`_bf16_rule`. The port's fp32 parameters
    are cast at use, as in training."""
    jargs = [jnp.asarray(a) for a in args]
    params = _jax_init(make_jax(jnp.float32), *jargs)

    def run(dt):
        jmod = make_jax(dt)
        out = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(
            params, *[a.astype(dt) for a in jargs])
        return np.asarray(out.astype(jnp.float32))

    tdt = getattr(torch, dtype)
    port = _carry(port, params, head)
    with torch.no_grad():
        got = port(*[torch.from_numpy(a).to(tdt) for a in args])
    got = got.float().numpy()
    want32 = run(jnp.float32)
    assert got.shape == want32.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want32, rtol=1e-4, atol=1e-4)
    else:
        _bf16_rule(got, run(jnp.bfloat16), want32, type(port).__name__)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seg_conv_matches_flax(dtype):
    x = _rand((2, 6, 10, 33), 17)
    _module_vs_flax(lambda dt: jlay.SegConv(21, dtype=dt),
                    tlay.SegConv(33, 21), [x], dtype, "seg_conv_final")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skip_ch,upsample_out", [(0, True), (7, False)])
def test_tpu_decoder_matches_flax(skip_ch, upsample_out, dtype):
    args = [_rand((2, 5, 9, 33), 18)]
    if skip_ch:
        args.append(_rand((2, 10, 18, skip_ch), 19))
    _module_vs_flax(
        lambda dt: jlay.TPUDecoder(32, has_skip=bool(skip_ch),
                                   upsample_out=upsample_out, dtype=dt),
        tlay.TPUDecoder(33, 32, skip_ch, upsample_out=upsample_out),
        args, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_subpixel_depth_activation_matches_flax(dtype):
    x = _rand((2, 6, 10, 40), 20)
    _module_vs_flax(lambda dt: jlay.SubpixelDepthActivation(1, dtype=dt),
                    tlay.SubpixelDepthActivation(40), [x], dtype)
