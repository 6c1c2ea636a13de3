"""The port's seg_block, space_to_depth and depth_to_space, bf16 sigmoid and
CPU bf16 conv against the JAX package's, and the reference seg layout, on
the CPU (beside tests/test_torch_model.py; a file of 8 or fewer tests
queues behind the suite's longest file under ``--dist loadfile``): bit for
bit (the sigmoid but where XLA flushes a subnormal result); a reference-
layout state_dict fails the strict load of the tpu_decoder variant.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camradepth_tpu.models import layers as jlay
from camradepth_tpu_torch.config import ModelConfig, preset
from camradepth_tpu_torch.models import layers as tlay
from camradepth_tpu_torch.models.camradepth import CamRaDepth, create_model
from tests.test_torch_model import SMALL, VARIANTS, _golden, _rand
from tests.torch_port import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seg_block_matches_jax_bit_for_bit(dtype):
    """Logits of few distinct values, so that most pixels hold exact ties
    among their largest classes: the first index wins on both sides."""
    rng = np.random.default_rng(23)
    logits = rng.integers(0, 3, (2, 7, 9, 21)).astype(np.float32) * 0.75
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    for n in (21, 19):
        v = logits[..., :n]
        got = tlay.seg_block(torch.from_numpy(v).to(tdt), n)
        want = jlay.seg_block(jnp.asarray(v, jdt), n)
        assert got.dtype == tdt and got.shape == (2, 7, 9, 1)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
        ties = (v == v.max(-1, keepdims=True)).sum(-1) > 1
        assert ties.mean() > 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_space_to_depth_matches_jax_bit_for_bit(dtype):
    x = _rand((2, 6, 10, 5), 24)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = torch.from_numpy(x).to(tdt)
    s2d = tlay.space_to_depth(t)
    np.testing.assert_array_equal(
        s2d.float().numpy(),
        np.asarray(jlay.space_to_depth(jnp.asarray(x, jdt)), np.float32))
    assert s2d.shape == (2, 3, 5, 20)
    d2s = tlay.depth_to_space(s2d)
    np.testing.assert_array_equal(
        d2s.float().numpy(),
        np.asarray(jlay.depth_to_space(jnp.asarray(s2d.float().numpy(),
                                                   jdt)), np.float32))
    assert torch.equal(d2s, t)
    # not torch's pixel_unshuffle, which orders the blocks (C, row, col)
    shuffled = torch.pixel_unshuffle(t.permute(0, 3, 1, 2), 2)
    assert not torch.equal(shuffled.permute(0, 2, 3, 1), s2d)


def test_reference_seg_layout_and_the_tpu_decoder_refusal():
    """The port's sup_unsup_seg has the reference layout, key for key and
    shape for shape (the golden's table; test_port_matches_committed_seg_
    golden_128x256 loads it strictly); a reference-layout state_dict given
    to the tpu_decoder variant fails the strict load (the CLI turns that
    into a one-line error, tests/test_torch_eval.py)."""
    shapes = _golden("flagship_seg_128x256.npz")["shapes"]
    cfg = dataclasses.replace(preset("sup_unsup_seg").model,
                              img_size=(128, 256))
    with torch.device("meta"):
        model = CamRaDepth(cfg)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == (
        shapes)
    small = ModelConfig(**SMALL, **VARIANTS["sup_unsup"])
    sd = create_model(small, device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="Missing key"):
        create_model(dataclasses.replace(small, tpu_decoder=True),
                     device="cpu", state_dict=sd)


def test_bf16_sigmoid_matches_jax_on_every_input():
    """The depth heads' bf16 sigmoid and its VJP equal XLA's (1 / (1 +
    exp(-x)) and g * (y * (1 - y)), each operation rounded) bit for bit on
    every finite bf16 input, against a seeded bf16 cotangent, except where
    XLA flushes a subnormal result to zero (both then lie under 1.2e-38).
    torch's one-rounding sigmoid differs from XLA's on about 1,100 of
    these inputs."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    x = x[torch.isfinite(x)]
    g = torch.from_numpy(_rand((x.numel(),), 22)).to(torch.bfloat16)

    def vjp(v, c):
        y, back = jax.vjp(jax.nn.sigmoid, v)
        return y, back(c)[0]

    def to_jax(t):
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)

    want = [np.asarray(v.astype(jnp.float32))
            for v in jax.jit(vjp)(to_jax(x), to_jax(g))]
    xg = x.clone().requires_grad_(True)
    y = tlay.sigmoid_for_dtype(xg)
    y.backward(g)
    assert y.dtype == xg.grad.dtype == torch.bfloat16
    for got, w in zip((y.detach(), xg.grad), want):
        got = got.float().numpy()
        flushed = (np.abs(got) < 1.2e-38) & (np.abs(w) < 1.2e-38)
        assert (got != w).sum() < 10
        np.testing.assert_array_equal(got[~flushed], w[~flushed])
    one = torch.sigmoid(x).float().numpy()
    assert (one != want[0]).sum() > 1000


def test_bf16_conv_on_cpu_is_a_rounded_fp32_conv():
    """The encoder's strided 8x8 sr-conv in bf16 on the CPU equals the fp32
    convolution of the same bf16 values, rounded once to bf16 (as cuDNN and
    XLA compute it), with the bias then added in bf16 (as flax adds it)."""
    conv = tlay.Conv2d(16, 16, 8, 8).to(torch.bfloat16)
    x = torch.from_numpy(_rand((2, 64, 64, 16), 16)).to(torch.bfloat16)
    with torch.no_grad():
        got = conv(x)
        want = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2).float(), conv.weight.float(),
            stride=8).to(torch.bfloat16).permute(0, 2, 3, 1) + conv.bias
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)
