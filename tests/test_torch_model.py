"""The port's model (camradepth_tpu_torch.models) against the JAX package
and the committed reference goldens, on the CPU.

Flax parameter trees (the JAX modules' init structure, numpy-seeded
values) come across through the port's state_dict_from_flax; inputs are
numpy-seeded and fed to both sides.
Tolerances:
- modules and the whole model in fp32: 1e-4 (the two frameworks sum convs
  and dots in other orders; errors stay near 1e-6 per op);
- the whole model in bf16: both sides round every op to bf16, but not at
  the same places (XLA:CPU evaluates some elementwise chains in fp32), so
  the two are independent bf16 roundings of one fp32 function. The port
  may differ from the JAX bf16 output by at most 1.5 times the JAX model's
  own bf16-vs-fp32 error, in mean and in max (measured: 1.03 to 1.16 in
  mean, 1.13 to 1.18 in max over the three maps; the GELU, which now
  rounds as JAX's, was not what set the ratio: with torch's fp32 GELU it
  was 1.05 to 1.15 and 0.95 to 1.22);
- the goldens: the tolerances of tests/test_flagship_golden.py:104-116 and
  tests/test_flagship_golden_fullres.py:42-45.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camradepth_tpu.config import ModelConfig as JaxModelConfig
from camradepth_tpu.interop.torch_convert import flax_params_to_state_dict
from camradepth_tpu.models import encoder as jenc
from camradepth_tpu.models import layers as jlay
from camradepth_tpu.models.camradepth import CamRaDepth as JaxCamRaDepth
from camradepth_tpu_torch.config import ModelConfig, preset
from camradepth_tpu_torch.interop.flax_convert import state_dict_from_flax
from camradepth_tpu_torch.interop.golden import (
    golden_input,
    shapes_from_json,
    synth_state_values,
)
from camradepth_tpu_torch.models import encoder as tenc
from camradepth_tpu_torch.models import layers as tlay
from camradepth_tpu_torch.models.camradepth import create_model
from tests.torch_port import one_torch_thread  # noqa: F401

GOLDENS = Path(__file__).parent / "goldens"
SMALL = dict(
    img_size=(64, 128), dims=(16, 32, 32, 64), heads=(1, 2, 4, 8),
    ff_expansion=(2, 2, 2, 2), sr_ratios=(8, 4, 2, 1), depths=(1, 1, 1, 1),
    mid_channels=32, input_channels=7, drop_path_rate=0.0,
)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_init(module, *args, seed=0, **kw):
    """Parameters of a flax module: the tree and shapes of its init (traced
    with jax.eval_shape, nothing compiled), values from numpy: norm scales
    near 1, small biases, kernels ~ N(0, 1/fan_in)."""
    shapes = jax.eval_shape(
        lambda key: module.init({"params": key}, *args, **kw),
        jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        g = rng.standard_normal(leaf.shape).astype(np.float32)
        name = path[-1].key
        if name == "scale":
            return 1.0 + 0.1 * g
        if name == "bias":
            return 0.1 * g
        return g / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _carry(port_module, params):
    sd = state_dict_from_flax(params)
    port_module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                                 for k, v in sd.items()}, strict=True)
    return port_module.eval()


@pytest.fixture(scope="module")
def small_jax_model():
    cfg = JaxModelConfig(**SMALL, compute_dtype="float32")
    model = JaxCamRaDepth(cfg)
    x = jnp.zeros((1, 64, 128, 7))
    return model, _jax_init(model, x, deterministic=True)


def test_state_dict_from_flax_matches_jax_converter(small_jax_model):
    _, params = small_jax_model
    want = flax_params_to_state_dict(params)
    got = state_dict_from_flax(params)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_state_dict_loads_strictly_into_port(small_jax_model):
    _, params = small_jax_model
    sd = state_dict_from_flax(params)
    model = create_model(ModelConfig(**SMALL, compute_dtype="float32"),
                         device="cpu", state_dict=sd)
    assert sorted(model.state_dict()) == sorted(sd)


@pytest.mark.parametrize("dim,heads,ratio,sr,hw", [
    (16, 1, 2, 8, (16, 32)), (32, 2, 4, 4, (8, 16)), (64, 8, 4, 1, (2, 4)),
])
def test_block_matches_flax(dim, heads, ratio, sr, hw):
    jmod = jenc.Block(dim, heads, mlp_ratio=ratio, sr_ratio=sr,
                      dtype=jnp.float32)
    x = _rand((2, hw[0] * hw[1], dim), 10)
    params = _jax_init(jmod, jnp.asarray(x), hw)
    want = np.asarray(jax.jit(lambda p, v: jmod.apply({"params": p}, v, hw))(
        params, jnp.asarray(x)))
    port = _carry(tenc.Block(dim, heads, ratio, sr), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x), hw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("in_ch,feat,patch,stride", [(7, 16, 7, 4),
                                                     (16, 32, 3, 2)])
def test_overlap_patch_embed_matches_flax(in_ch, feat, patch, stride):
    jmod = jenc.OverlapPatchEmbed(feat, patch, stride, dtype=jnp.float32)
    x = _rand((2, 20, 36, in_ch), 11)
    params = _jax_init(jmod, jnp.asarray(x))
    want = np.asarray(jax.jit(lambda p, v: jmod.apply({"params": p}, v))(
        params, jnp.asarray(x)))
    port = _carry(tenc.OverlapPatchEmbed(in_ch, feat, patch, stride), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("in_ch,skip_ch", [(33, 0), (32, 7)])
def test_decoder_matches_flax(in_ch, skip_ch):
    jmod = jlay.Decoder(32, has_skip=bool(skip_ch), dtype=jnp.float32)
    x = _rand((2, 5, 9, in_ch), 12)
    args = [jnp.asarray(x)]
    skip = None
    if skip_ch:
        skip = _rand((2, 10, 18, skip_ch), 13)
        args.append(jnp.asarray(skip))
    params = _jax_init(jmod, *args)
    want = np.asarray(jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(
        params, *args))
    port = _carry(tlay.Decoder(in_ch, 32, skip_ch), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x),
                   None if skip is None else torch.from_numpy(skip)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_depth_activation_matches_flax():
    jmod = jlay.DepthActivation(1, dtype=jnp.float32)
    x = _rand((2, 12, 20, 33), 14)
    params = _jax_init(jmod, jnp.asarray(x))
    want = np.asarray(jax.jit(lambda p, v: jmod.apply({"params": p}, v))(
        params, jnp.asarray(x)))
    port = _carry(tlay.DepthActivation(33), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _outputs(out):
    d = out["depth"]
    return {"final": d["final_depth"], "inter3": d["intermediate_depths"][2],
            "inter4": d["intermediate_depths"][3]}


def _jax_forward(cfg, params, x, dtype):
    model = JaxCamRaDepth(dataclasses.replace(cfg, compute_dtype=dtype))
    out = jax.jit(lambda p, v: model.apply({"params": p}, v))(
        params, jnp.asarray(x))
    return {k: np.asarray(v) for k, v in _outputs(out).items()}


@pytest.fixture(scope="module")
def whole_model_jax(small_jax_model):
    """The whole-model input and the JAX model's outputs on it for a
    compute dtype, each dtype's computed once: the bf16 case also reads the
    fp32 outputs, which the fp32 case has computed by then."""
    jmodel, params = small_jax_model
    x = _rand((2, 64, 128, 7), 15)
    outputs = {}

    def jax_outputs(dtype):
        if dtype not in outputs:
            outputs[dtype] = _jax_forward(jmodel.cfg, params, x, dtype)
        return outputs[dtype]

    return x, jax_outputs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_model_matches_jax(small_jax_model, whole_model_jax, dtype):
    _, params = small_jax_model
    x, jax_outputs = whole_model_jax
    want = jax_outputs(dtype)
    port = create_model(ModelConfig(**SMALL, compute_dtype=dtype),
                        device="cpu", state_dict=state_dict_from_flax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got["depth"]["intermediate_depths"][:2] == (None, None)
    assert all(v is None for v in got["seg"].values())
    got = {k: v.numpy() for k, v in _outputs(got).items()}
    if dtype == "bfloat16":
        # the JAX model's own bf16 rounding error sets the scale
        ref32 = jax_outputs("float32")
    for key, w in want.items():
        g = got[key]
        assert g.dtype == np.float32 and g.shape == w.shape, key
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=key)
        else:
            err, own = np.abs(g - w), np.abs(w - ref32[key])
            assert err.mean() <= 1.5 * own.mean(), (key, err.mean(),
                                                    own.mean())
            assert err.max() <= 1.5 * own.max(), (key, err.max(), own.max())


def _golden(name):
    with np.load(GOLDENS / name) as z:
        out = {k: z[k] for k in z.files if k != "shapes_json"}
        out["shapes"] = shapes_from_json(bytes(z["shapes_json"]).decode())
    return out


def _golden_forward(golden, hw):
    cfg = dataclasses.replace(preset("base").model, img_size=hw,
                              compute_dtype="float32")
    model = create_model(cfg, device="cpu",
                         state_dict=synth_state_values(golden["shapes"]))
    with torch.no_grad():
        return model(torch.from_numpy(golden_input(hw)))


def test_port_matches_committed_golden_128x256():
    """The base preset's full depths (3,10,16,5) and widths at 128x256,
    reference weights synthesized from the committed shape table."""
    golden = _golden("flagship_128x256.npz")
    out = _golden_forward(golden, (128, 256))
    np.testing.assert_allclose(out["depth"]["final_depth"].numpy(),
                               golden["final_depth"], rtol=2e-3, atol=5e-4)
    np.testing.assert_allclose(out["depth"]["intermediate_depths"][2].numpy(),
                               golden["inter2"], rtol=2e-3, atol=5e-4)
    np.testing.assert_allclose(out["depth"]["intermediate_depths"][3].numpy(),
                               golden["inter3"], rtol=2e-3, atol=5e-4)


def test_port_matches_committed_golden_416x800():
    """The shipping geometry (fp16 maps plus an fp32 crop anchor)."""
    golden = _golden("flagship_416x800.npz")
    out = _golden_forward(golden, (416, 800))
    final = out["depth"]["final_depth"].numpy()
    cy, cx = golden["crop_yx"]
    np.testing.assert_allclose(final[:, cy:cy + 64, cx:cx + 128],
                               golden["final_depth_crop"], rtol=2e-3,
                               atol=5e-4)
    np.testing.assert_allclose(final,
                               golden["final_depth_f16"].astype(np.float32),
                               rtol=2e-3, atol=1.5e-3)
    np.testing.assert_allclose(out["depth"]["intermediate_depths"][2].numpy(),
                               golden["inter2"], rtol=2e-3, atol=5e-4)
    np.testing.assert_allclose(
        out["depth"]["intermediate_depths"][3].numpy(),
        golden["inter3_f16"].astype(np.float32), rtol=2e-3, atol=1.5e-3)


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
