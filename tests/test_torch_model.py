"""The port's whole model (camradepth_tpu_torch.models) against the JAX
package's, on the CPU, and the helpers of its module and golden tests
(tests/test_torch_model_{layers,heads,ops,goldens}.py, kept apart from
this file so that each queues behind the suite's longest file under ``--dist
loadfile``).

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
- seg_block, space_to_depth and depth_to_space (test_torch_model_ops.py):
  bit for bit in both dtypes;
- the goldens (test_torch_model_goldens.py): the tolerances of
  tests/test_flagship_golden.py:104-154,
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
from camradepth_tpu.models.camradepth import CamRaDepth as JaxCamRaDepth
from camradepth_tpu_torch.config import ModelConfig
from camradepth_tpu_torch.interop.flax_convert import state_dict_from_flax
from camradepth_tpu_torch.interop.golden import shapes_from_json
from camradepth_tpu_torch.models.camradepth import create_model
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


def _bf16_rule(got, want, ref32, what):
    """bf16 against the JAX bf16 output: at most 1.5 times the JAX
    module's own bf16-vs-fp32 error, in mean and in max."""
    err, own = np.abs(got - want), np.abs(want - ref32)
    assert err.mean() <= 1.5 * own.mean(), (what, err.mean(), own.mean())
    assert err.max() <= 1.5 * own.max(), (what, err.max(), own.max())


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
