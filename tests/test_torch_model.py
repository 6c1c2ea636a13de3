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
- the seg variants and the tpu_decoder variant (at 32x64): depth and
  the seg logits as above. A guidance pixel whose two largest logits lie
  within the frameworks' roundoff flips its argmax and moves the depth
  heads' output near it (at 64x128 from seed 1, one unsup stage-4 pixel
  with a top-2 gap of 2.4e-7 moved 25 of the 4,096 stage-4 depth pixels
  by up to 6.3e-3): a flip that says nothing of the code under test. So
  the variants' parameters are seeded (VARIANT_SEED) so that in fp32
  every guidance pixel's two largest logits lie more than twice that
  pixel's largest port-vs-JAX logit difference apart, which the test
  asserts first; the argmax maps (final and stage-4 labels, unsup_map)
  are then equal in fp32. In bf16 the maps are held by agreement, since
  near-tie pixels flip between frameworks (tests/test_flagship_golden.py:
  131-140): a disagreement at most 1.5 times the JAX model's own
  bf16-vs-fp32 disagreement plus 0.5 %;
- seg_block, space_to_depth and depth_to_space: bit for bit in both
  dtypes;
- the goldens: the tolerances of tests/test_flagship_golden.py:104-154,
  tests/test_flagship_golden_fullres.py:42-45 and
  tests/test_tpu_decoder_golden.py:76-79.
"""

import concurrent.futures
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camradepth_tpu.config import ModelConfig as JaxModelConfig
from camradepth_tpu.interop import golden as jax_golden
from camradepth_tpu.interop.torch_convert import flax_params_to_state_dict
from camradepth_tpu.models import encoder as jenc
from camradepth_tpu.models import layers as jlay
from camradepth_tpu.models.camradepth import CamRaDepth as JaxCamRaDepth
from camradepth_tpu_torch.config import ModelConfig, preset
from camradepth_tpu_torch.interop.flax_convert import state_dict_from_flax
from camradepth_tpu_torch.interop.golden import (
    flax_param_shapes,
    golden_input,
    shapes_from_json,
    synth_flax_params,
    synth_state_values,
)
from camradepth_tpu_torch.models import encoder as tenc
from camradepth_tpu_torch.models import layers as tlay
from camradepth_tpu_torch.models.camradepth import CamRaDepth, create_model
from tests.torch_port import one_torch_thread  # noqa: F401

GOLDENS = Path(__file__).parent / "goldens"
SMALL = dict(
    img_size=(64, 128), dims=(16, 32, 32, 64), heads=(1, 2, 4, 8),
    ff_expansion=(2, 2, 2, 2), sr_ratios=(8, 4, 2, 1), depths=(1, 1, 1, 1),
    mid_channels=32, input_channels=7, drop_path_rate=0.0,
)


# the model variants of the whole-model test besides base, each in fp32;
# those of BF16_VARIANTS in bf16 too (each case costs a JAX compile;
# tpu_decoder+sup_unsup holds every kind of stage and head of the others).
# supervised_seg alone runs no code that sup_unsup does not; unsup alone
# feeds its map into the seg features, which no other variant does; base
# with tpu_decoder alone is held to its golden at full depth
# (test_port_matches_committed_tpu_decoder_golden_128x256)
VARIANTS = {
    "unsup": dict(unsupervised_seg=True),
    "sup_unsup": dict(supervised_seg=True, unsupervised_seg=True),
    "tpu_decoder+sup_unsup": dict(tpu_decoder=True, supervised_seg=True,
                                  unsupervised_seg=True),
}
BF16_VARIANTS = ("tpu_decoder+sup_unsup",)
# the variants run at 32x64 (a quarter of the pixels of base's 64x128),
# with parameters from VARIANT_SEED, the first seed from 1 at which no
# guidance pixel lies near a tie (see the module docstring)
VARIANT_HW = (32, 64)
VARIANT_SEED = 2
# the seg heads whose argmax maps feed the depth heads
GUIDANCE_HEADS = ("seg_conv_stage_4", "unsup_stage_4", "seg_conv_final",
                  "unsup_final")


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


def _carry(port_module, params, head=None):
    """Load flax ``params`` into ``port_module``; ``head`` names a bare seg
    head, whose wrapper level the converter drops by that name."""
    if head is None:
        sd = state_dict_from_flax(params)
    else:
        sd = {k.removeprefix(head + "."): v
              for k, v in state_dict_from_flax({head: params}).items()}
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


def _bf16_rule(got, want, ref32, what):
    """bf16 against the JAX bf16 output: at most 1.5 times the JAX
    module's own bf16-vs-fp32 error, in mean and in max."""
    err, own = np.abs(got - want), np.abs(want - ref32)
    assert err.mean() <= 1.5 * own.mean(), (what, err.mean(), own.mean())
    assert err.max() <= 1.5 * own.max(), (what, err.max(), own.max())


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


def _outputs(out):
    d = out["depth"]
    got = {"final": d["final_depth"], "inter3": d["intermediate_depths"][2],
           "inter4": d["intermediate_depths"][3]}
    seg = out["seg"]
    for key in ("final_seg", "intermediate_seg", "unsup_map"):
        if seg[key] is not None:
            got[key] = seg[key]
    return got


# the (variant, dtype) cases of test_whole_model_matches_jax
WHOLE_MODEL_CASES = ([("base", "float32"), ("base", "bfloat16")]
                     + [(v, "float32") for v in VARIANTS]
                     + [(v, "bfloat16") for v in BF16_VARIANTS])


@pytest.fixture(scope="module")
def whole_model_jax(small_jax_model):
    """For each variant (base and VARIANTS): its input, its parameters and
    the JAX model's outputs in a dtype with, in fp32, the logits of its
    guidance heads. Every case's forward is traced when the fixture is
    made and compiled on a pool of threads (XLA's compiler leaves the
    interpreter lock), so the compiles overlap each other and the tests;
    each case runs when a test first asks for it."""
    jmodel, base_params = small_jax_model
    inputs = {"base": _rand((2, 64, 128, 7), 15),
              "variant": _rand((2, *VARIANT_HW, 7), 15)}
    params, outputs, compiled = {"base": base_params}, {}, {}

    def cfg_of(name, **kw):
        if name == "base":
            return dataclasses.replace(jmodel.cfg, **kw)
        return dataclasses.replace(jmodel.cfg, img_size=VARIANT_HW,
                                   **VARIANTS[name], **kw)

    def x_of(name):
        return inputs["base" if name == "base" else "variant"]

    def params_of(name):
        if name not in params:
            params[name] = _jax_init(JaxCamRaDepth(cfg_of(name)),
                                     jnp.asarray(x_of(name)),
                                     seed=VARIANT_SEED, deterministic=True)
        return params[name]

    def heads_of(name, dtype):
        return dtype == "float32" and name != "base"

    def forward(name, dtype):
        model = JaxCamRaDepth(cfg_of(name, compute_dtype=dtype))
        if heads_of(name, dtype):
            return lambda p, v: model.apply(
                {"params": p}, v, capture_intermediates=lambda mod, _: (
                    mod.name in GUIDANCE_HEADS))
        return lambda p, v: model.apply({"params": p}, v)

    def jax_outputs(name, dtype):
        if (name, dtype) not in outputs:
            out = compiled[name, dtype].result()(params_of(name),
                                                 jnp.asarray(x_of(name)))
            heads = {}
            if heads_of(name, dtype):
                out, inter = out
                heads = {k: np.asarray(v["__call__"][0]) for k, v in
                         inter.get("intermediates", {}).items()}
            outputs[name, dtype] = ({k: np.asarray(v) for k, v in
                                     _outputs(out).items()}, heads)
        return outputs[name, dtype]

    with concurrent.futures.ThreadPoolExecutor(len(WHOLE_MODEL_CASES)) as pool:
        for name, dtype in WHOLE_MODEL_CASES:
            compiled[name, dtype] = pool.submit(jax.jit(
                forward(name, dtype)).lower(
                    params_of(name), jnp.asarray(x_of(name))).compile)
        yield x_of, params_of, jax_outputs


def _agreement(a, b):
    return float(np.mean(a == b))


def _labels(out):
    """The argmax maps of a model's outputs."""
    maps = {k: out[k].argmax(-1) for k in ("final_seg", "intermediate_seg")
            if k in out}
    if "unsup_map" in out:
        maps["unsup_map"] = out["unsup_map"][..., 0]
    return maps


def _assert_no_near_ties(got, want, cfg):
    """Every guidance pixel's two largest JAX logits lie more than twice
    that pixel's largest port-vs-JAX logit difference apart, so that both
    argmax maps, and all that reads them, agree (a tpu_decoder final head
    holds the 2x2 block's four pixels in its channels)."""
    assert sorted(got) == sorted(want) and want, (sorted(got), sorted(want))
    for name, w in want.items():
        classes = cfg.num_classes if name.startswith("seg") else (
            cfg.unsup_classes)
        w = w.reshape(*w.shape[:-1], -1, classes)
        top2 = np.sort(w, axis=-1)[..., -2:]
        gap = top2[..., 1] - top2[..., 0]
        diff = np.abs(got[name].reshape(w.shape) - w).max(-1)
        worst = np.argmin(gap - 2 * diff)
        assert (gap > 2 * diff).all(), (name, gap.ravel()[worst],
                                        diff.ravel()[worst])


@pytest.mark.parametrize("variant,dtype", [
    pytest.param(v, d, id=d if v == "base" else f"{v}-{d}")
    for v, d in WHOLE_MODEL_CASES])
def test_whole_model_matches_jax(whole_model_jax, variant, dtype):
    x_of, params_of, jax_outputs = whole_model_jax
    want, want_heads = jax_outputs(variant, dtype)
    cfg = ModelConfig(**SMALL, compute_dtype=dtype)
    if variant != "base":
        cfg = dataclasses.replace(cfg, img_size=VARIANT_HW,
                                  **VARIANTS[variant])
    port = create_model(cfg, device="cpu",
                        state_dict=state_dict_from_flax(params_of(variant)))
    heads = {}
    for name in GUIDANCE_HEADS:
        if hasattr(port, name):
            getattr(port, name).register_forward_hook(
                lambda mod, args, y, name=name: heads.__setitem__(
                    name, y.float().numpy()))
    with torch.no_grad():
        got = port(torch.from_numpy(x_of(variant)))
    assert got["depth"]["intermediate_depths"][:2] == (None, None)
    if variant == "base":
        assert all(v is None for v in got["seg"].values())
    got = {k: v.numpy() for k, v in _outputs(got).items()}
    assert got.keys() == want.keys()
    labels_got, labels_want = _labels(got), _labels(want)
    if dtype == "bfloat16":
        # the JAX model's own bf16 rounding error sets the scale
        ref32 = jax_outputs(variant, "float32")[0]
    elif labels_want:
        _assert_no_near_ties(heads, want_heads, cfg)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == np.float32 and g.shape == w.shape, key
        if key == "unsup_map":
            continue  # an argmax map: compared below
        if dtype == "bfloat16":
            _bf16_rule(g, w, ref32[key], key)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=key)
    for key, w in labels_want.items():
        if dtype == "float32":
            np.testing.assert_array_equal(labels_got[key], w, err_msg=key)
        else:
            agree = _agreement(labels_got[key], w)
            own = 1.0 - _agreement(w, _labels(ref32)[key])
            assert 1.0 - agree <= 1.5 * own + 0.005, (key, agree, own)


def _golden(name):
    with np.load(GOLDENS / name) as z:
        out = {k: z[k] for k in z.files if k != "shapes_json"}
        out["shapes"] = shapes_from_json(bytes(z["shapes_json"]).decode())
    return out


def _golden_forward(golden, hw, name="base", state_dict=None, **kw):
    cfg = dataclasses.replace(preset(name).model, img_size=hw,
                              compute_dtype="float32", **kw)
    if state_dict is None:
        state_dict = synth_state_values(golden["shapes"])
    model = create_model(cfg, device="cpu", state_dict=state_dict)
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


def test_port_matches_committed_seg_golden_128x256():
    """sup_unsup_seg at the full depths and widths at 128x256, reference
    weights synthesized from the committed shape table, with the limits
    of tests/test_flagship_golden.py:118-154: the depth heads read the
    argmax guidance maps, so a flipped near-tie pixel moves depth near
    it."""
    golden = _golden("flagship_seg_128x256.npz")
    out = _golden_forward(golden, (128, 256), "sup_unsup_seg")
    seg = out["seg"]["final_seg"].numpy()
    cy, cx = golden["crop_yx"]
    np.testing.assert_allclose(seg[:, cy:cy + 32, cx:cx + 64],
                               golden["final_seg_crop"], rtol=2e-3,
                               atol=1e-3)
    flips = seg.argmax(-1) != golden["final_seg_argmax"]
    assert flips.mean() < 0.005, flips.mean()
    unsup = out["seg"]["unsup_map"].numpy() == golden["unsup_map"]
    assert unsup.mean() > 0.995, unsup.mean()
    got = out["depth"]["final_depth"].numpy()[0, ..., 0]
    want = golden["final_depth"][0, ..., 0]
    err = np.abs(got - want)
    assert (err <= 5e-4 + 2e-3 * np.abs(want)).mean() > 0.995
    assert np.median(err) < 2e-4 and err.max() < 0.2
    np.testing.assert_allclose(out["depth"]["intermediate_depths"][2].numpy(),
                               golden["inter2"], rtol=2e-3, atol=5e-4)


def test_port_matches_committed_tpu_decoder_golden_128x256():
    """base with tpu_decoder at the full depths and widths at 128x256:
    flax parameters synthesized by the port's own golden copy from the
    committed flax shape table, carried by state_dict_from_flax."""
    golden = _golden("tpu_decoder_128x256.npz")
    sd = state_dict_from_flax(synth_flax_params(golden["shapes"]))
    out = _golden_forward(golden, (128, 256), state_dict=sd,
                          tpu_decoder=True)
    d = out["depth"]
    for key, got in (("final_depth", d["final_depth"]),
                     ("inter_depth_3", d["intermediate_depths"][2]),
                     ("inter_depth_4", d["intermediate_depths"][3])):
        np.testing.assert_allclose(got.numpy(), golden[key], rtol=5e-4,
                                   atol=5e-6, err_msg=key)


def test_golden_synthesis_matches_jax_package():
    """The port's flax_param_shapes and synth_flax_params give the JAX
    package's shape table and values bit for bit, from the tpu_decoder
    golden's table."""
    shapes = _golden("tpu_decoder_128x256.npz")["shapes"]
    want = jax_golden.synth_flax_params(shapes)
    got = synth_flax_params(shapes)
    assert flax_param_shapes(got) == jax_golden.flax_param_shapes(want) == (
        shapes)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_want) == len(shapes)
    for path, w in flat_want:
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_array_equal(g, w)


def test_state_dict_from_flax_covers_every_variant_leaf(whole_model_jax):
    """tpu_decoder + sup_unsup: every flax leaf lands on its own port key,
    and the state_dict loads strictly."""
    flax = whole_model_jax[1]("tpu_decoder+sup_unsup")
    sd = state_dict_from_flax(flax)
    assert len(sd) == len(jax.tree_util.tree_leaves(flax))
    cfg = ModelConfig(**SMALL, compute_dtype="float32",
                      **VARIANTS["tpu_decoder+sup_unsup"])
    model = create_model(cfg, device="cpu", state_dict=sd)
    assert sorted(model.state_dict()) == sorted(sd)
    assert "depth_upsample.3.conv_0.model.0.weight" in sd
    assert "seg_upsample.1.conv_2.model.1.bias" in sd


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
