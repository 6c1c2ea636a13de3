"""The port's prep estimators and component blocks against the JAX
package's, on the same weights and numpy-seeded inputs, on the CPU.

- RAFT-large (``models/raft.py``): the official key set that
  ``tests/test_raft.py`` synthesizes loads strictly into the port's
  module, and the same state_dict goes through the JAX loader; 64x64, 2
  iterations, flow rtol/atol 1e-4 px.
- Panoptic-DeepLab R101-os32 (``models/panoptic_deeplab.py``): the port's
  state_dict has the keys of the JAX tests' torch mirror; random weights
  with BatchNorm statistics through both; 65x129, semantic / center /
  offset rtol/atol 1e-4 (the JAX test's own limit), the class maps of
  ``classmap_fn`` equal where the top-2 logit gap clears the frameworks'
  difference (asserted for every pixel first).
- ``models/alt_blocks.py``: each block with JAX's initial weights (its
  1-D parameters moved off 1 and 0), fp32 rtol 1e-5, atol 1e-6 times the
  output's largest magnitude.
- Lucas-Kanade (``ops/optical_flow.py``): the JAX tests' translation,
  identity and RGB cases, atol 1e-4 px.

The module's ``jax_refs`` fixture traces every JAX program in turn on a
thread of its own and compiles and runs each on a pool of threads (XLA's
compiler leaves the interpreter lock) as soon as it is traced, so the
compiles overlap the later traces and the port's runs, and each test
waits only for its own program.
"""

import concurrent.futures
import re
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camradepth_tpu.models import alt_blocks as jax_ab
from camradepth_tpu.models import panoptic_deeplab as jax_pdl
from camradepth_tpu.models import raft as jax_raft
from camradepth_tpu.ops import optical_flow as jax_lk
from camradepth_tpu_torch.models import alt_blocks as ab
from camradepth_tpu_torch.models import panoptic_deeplab as pdl
from camradepth_tpu_torch.models import raft
from camradepth_tpu_torch.ops.optical_flow import lk_flow
from tests.test_panoptic_deeplab import TorchPDL, _randomized_state
from tests.test_raft import _official_raft_state
from tests.torch_port import one_torch_thread  # noqa: F401


RAFT_STATE = _official_raft_state(seed=7)
_rng = np.random.default_rng(4)
RAFT_IM1 = _rng.integers(0, 255, (1, 64, 64, 3)).astype(np.float32)
RAFT_IM2 = (np.roll(RAFT_IM1, (2, 3), axis=(1, 2))
            + _rng.uniform(-5, 5, RAFT_IM1.shape)).astype(np.float32)
PDL_HW = (56, 120)  # padded to 65x129
PDL_IM = np.random.default_rng(3).integers(0, 255, PDL_HW + (3,), np.uint8)


def _textured(h, w, seed=0):
    """The JAX tests' texture: uniform noise, 5x5 box-blurred with zero
    padding (``scipy.signal.convolve2d(base, ones((5, 5)) / 25,
    mode="same")``, summed here in numpy to within 1.2e-13 of it, which
    spares the ~3 s import of scipy.signal)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h + 32, w + 32))
    pad, (hh, ww) = np.pad(base, 2), base.shape
    return sum(pad[a:a + hh, b:b + ww] for a in range(5)
               for b in range(5)) / 25


def _lk_cases():
    """The JAX tests' cases at their translation case's 96x128: content
    moved by (-3, -2), an identical pair, an RGB pair moved by one column."""
    big = _textured(96, 128)
    im = _textured(96, 128, seed=1)[:96, :128]
    rgb = np.repeat(_textured(96, 128, 2)[:96, :128, None], 3,
                    axis=-1).astype(np.uint8)
    # im2 cropped at (+2, +3) moves the content by (-3, -2)
    return {"translation": (big[8:104, 8:136], big[10:106, 11:139]),
            "identity": (im, im),
            "rgb": (rgb, np.roll(rgb, 1, axis=1))}


def _pdl_canvas(im):
    """The classmap's input: the frame mean-padded to the reference's odd
    size and normalized (``classmap_fn``'s steps)."""
    h, w = im.shape[:2]
    ph, pw = jax_pdl._pad_hw(h, w)
    canvas = np.empty((ph, pw, 3), np.float32)
    canvas[:] = np.asarray(jax_pdl.MEAN, np.float32)
    canvas[:h, :w] = im
    return canvas


def _alt_params(jb, x, kw, seed):
    """Weights for a JAX alt block: its parameter tree's shapes, filled
    from numpy (kernels ~ N(0, 1/fan_in), scales 1 + 0.1 N, biases 0.1 N)."""
    shapes = jax.eval_shape(lambda k: jb.init({"params": k}, x, **kw)[
        "params"], jax.ShapeDtypeStruct((2,), jnp.uint32))
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for path, leaf in leaves:
        name = str(path[-1].key)
        v = rng.standard_normal(leaf.shape)
        if name == "kernel":
            v /= np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            v = 0.1 * v + (1.0 if name == "scale" else 0.0)
        out.append(jnp.asarray(v, jnp.float32))
    return jax.tree_util.tree_unflatten(tree, out)


@pytest.fixture(scope="module")
def deeplab():
    """(the port's model with random weights and BN statistics, its
    state_dict)."""
    model = _randomized_state(pdl.PanopticDeepLab(), seed=0).eval()
    return model, model.state_dict()


def _jax_programs(state_dict):
    """The module's JAX programs, traced one after another: yields (group,
    run), where ``run()`` compiles the traced program, runs it and returns
    {result name: (outputs, params)} as numpy; the alt blocks are one
    program and the LK cases one (one image shape)."""
    raft_params = jax_raft.load_torch_raft_state_dict(RAFT_STATE)
    raft_prog = jax_raft.raft_flow_fn(raft_params, iters=2).lower(
        RAFT_IM1, RAFT_IM2)
    yield "raft", lambda: {"raft": (np.asarray(raft_prog.compile()(
        jnp.asarray(RAFT_IM1), jnp.asarray(RAFT_IM2))), None)}
    # the JAX loader's registration-order map (param_order, _to_flax),
    # without its eval_shape check of the tree, which JAX's own
    # tests/test_panoptic_deeplab.py makes and apply repeats
    params = {}
    for (key, value), (path, role) in zip(
            ((k, v) for k, v in state_dict.items()
             if not k.endswith("num_batches_tracked")),
            jax_pdl.param_order()):
        node = params
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = jax_pdl._to_flax(value.numpy(), role)
    jmodel = jax_pdl.PanopticDeepLab()
    canvas = jnp.asarray(_pdl_canvas(PDL_IM))
    x = (canvas - jnp.asarray(jax_pdl.MEAN)) / jnp.asarray(jax_pdl.STD)
    pdl_prog = jax.jit(lambda p, v: jmodel.apply({"params": p}, v)).lower(
        params, x[None])
    yield "pdl", lambda: {"pdl": (jax.tree.map(np.asarray, pdl_prog.compile()(
        params, x[None])), None)}
    blocks, alt_params, alt_x = [], [], []
    for name, jax_block, _, cin, kw in ALT:
        v = jnp.asarray(_alt_input(name, cin))
        jb = jax_block()
        blocks.append((jb, kw))
        alt_params.append(_alt_params(jb, v, kw, seed=5))
        alt_x.append(v)
    alt_prog = jax.jit(lambda ps, xs: tuple(
        jb.apply({"params": p}, v, **kw)
        for (jb, kw), p, v in zip(blocks, ps, xs))).lower(alt_params, alt_x)

    def run_alt():
        res = alt_prog.compile()(alt_params, alt_x)
        return {name: (np.asarray(r), jax.tree.map(np.asarray, p))
                for (name, *_), r, p in zip(ALT, res, alt_params)}

    yield "alt", run_alt
    gray = {name: tuple(jax_lk._to_gray(jnp.asarray(im, jnp.float32) / 255.0)
                        for im in pair) for name, pair in _lk_cases().items()}
    lk_prog = jax_lk._lk_pyramid.lower(*gray["translation"], levels=4,
                                       radius=7, iters=3)

    def run_lk():
        compiled = lk_prog.compile()
        return {name: (np.asarray(compiled(*g)), None)
                for name, g in gray.items()}

    yield "lk", run_lk


def _group(name):
    """The program of a result name (an LK case, an alt block, or its own)."""
    if name in ("raft", "pdl"):
        return name
    return "lk" if name in ("translation", "identity", "rgb") else "alt"


@pytest.fixture(scope="module", autouse=True)
def jax_refs(deeplab):
    """name -> (the JAX outputs, the params) of ``_jax_programs``, made on
    threads of their own from the module's start while the port's side of
    each test runs: one thread traces the programs in turn and hands each
    to a pool that compiles and runs it (XLA's compiler leaves the
    interpreter lock), so a test waits only for its own program."""
    groups = {g: concurrent.futures.Future()
              for g in ("raft", "pdl", "alt", "lk")}

    def copy(src, dst):
        exc = src.exception()
        dst.set_exception(exc) if exc else dst.set_result(src.result())

    def trace(pool):
        try:
            for group, run in _jax_programs(deeplab[1]):
                pool.submit(run).add_done_callback(
                    lambda f, g=groups[group]: copy(f, g))
        except BaseException as e:
            for g in groups.values():
                if not g.done():
                    g.set_exception(e)
            raise

    with concurrent.futures.ThreadPoolExecutor(len(groups) + 1) as pool:
        tracer = pool.submit(trace, pool)
        yield lambda name: groups[_group(name)].result()[name]
        tracer.result()


# -- RAFT ------------------------------------------------------------------


def test_raft_loads_the_official_key_set_and_matches_jax(jax_refs):
    model = raft.load_official_state_dict(raft.RAFT(iters=2), RAFT_STATE)
    assert set(model.state_dict()) == {k.removeprefix("module.")
                                       for k in RAFT_STATE}
    got = raft.raft_flow_fn(RAFT_STATE, iters=2, device="cpu")(
        RAFT_IM1, RAFT_IM2).numpy()
    want = jax_refs("raft")[0]
    assert got.shape == (1, 64, 64, 2)
    assert np.abs(want).max() > 0.5  # the flow is not trivially small
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the model stays in eval semantics (frozen BatchNorm)
    assert not raft.RAFT(iters=1).train().training


# -- Panoptic-DeepLab -------------------------------------------------------


def test_deeplab_state_dict_is_the_mirror_key_set(deeplab):
    model, sd = deeplab
    with torch.device("meta"):
        mirror = TorchPDL().state_dict()
    assert list(sd) == list(mirror)
    assert all(sd[k].shape == mirror[k].shape for k in sd)
    assert sum(not k.endswith("num_batches_tracked") for k in sd) == \
        pdl.NUM_TENSORS
    # any naming loads by registration order, as the JAX loader does
    renamed = {f"m.{i}.x": v for i, (k, v) in enumerate(sd.items())
               if not k.endswith("num_batches_tracked")}
    with torch.device("meta"):
        other = pdl.PanopticDeepLab()
    other = pdl.load_state_dict_by_order(other.to_empty(device="cpu"),
                                         renamed)
    assert all(torch.equal(other.state_dict()[k], v) for k, v in sd.items()
               if not k.endswith("num_batches_tracked"))
    renamed.pop("m.0.x")
    with pytest.raises(ValueError, match="tensors"):
        pdl.load_state_dict_by_order(other, renamed)


def test_deeplab_matches_jax_and_classmap(deeplab, jax_refs):
    model = deeplab[0]
    h, w = pdl._pad_hw(*PDL_HW)
    assert (h, w) == jax_pdl._pad_hw(*PDL_HW) == (65, 129)
    canvas = _pdl_canvas(PDL_IM)
    x = ((canvas - np.asarray(pdl.MEAN, np.float32))
         / np.asarray(pdl.STD, np.float32))[None]
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    want = jax_refs("pdl")[0]
    for key in ("semantic", "center", "offset"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)

    cls = pdl.classmap_fn(model, device="cpu")(PDL_IM)
    assert cls.shape == PDL_HW and cls.dtype == np.int64
    # every pixel's top-2 gap of the port's upsampled logits clears the
    # frameworks' largest logit difference, so the argmax maps must agree
    tl = pdl.resize_bilinear_ac(got["semantic"], (h, w))[0, :PDL_HW[0],
                                                         :PDL_HW[1]].numpy()
    jl = np.asarray(jax_pdl.resize_bilinear_ac(jnp.asarray(
        want["semantic"]), (h, w)))[0, :PDL_HW[0], :PDL_HW[1]]
    top2 = np.sort(tl, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    diff = np.abs(tl - jl).max()
    assert gap.min() > 2 * diff, (gap.min(), diff)
    # JAX's classmap steps (``_classmap``) on JAX's logits
    np.testing.assert_array_equal(cls, np.asarray(jnp.argmax(
        jax_pdl.resize_bilinear_ac(jnp.asarray(want["semantic"]), (h, w)),
        axis=-1))[0, :PDL_HW[0], :PDL_HW[1]])
    np.testing.assert_array_equal(cls, tl.argmax(-1))
    assert set(np.unique(cls)) <= set(range(pdl.NUM_CLASSES))
    assert pdl.VEHICLE_CLASSES == jax_pdl.VEHICLE_CLASSES


def test_estimators_take_the_preps_flipped_views(deeplab):
    """The prep's stages hand the estimators ``cv2.imread(...)[..., ::-1]``,
    a view with a negative stride (``dataprep/stages.py`` compute_flow,
    semantic_seg_artifact): the same maps as on a contiguous copy."""
    bgr = PDL_IM[..., ::-1].copy()
    est = pdl.classmap_fn(deeplab[0], device="cpu")
    np.testing.assert_array_equal(est(bgr[..., ::-1]), est(PDL_IM))
    run = raft.raft_flow_fn(RAFT_STATE, iters=1, device="cpu")
    a, b = RAFT_IM1[..., ::-1].copy(), RAFT_IM2[..., ::-1].copy()
    torch.testing.assert_close(run(a[..., ::-1], b[..., ::-1]),
                               run(RAFT_IM1, RAFT_IM2), rtol=0, atol=0)


# -- alt_blocks ---------------------------------------------------------------


def _port_state(params) -> dict:
    """A Flax tree of the alt blocks -> the port's state_dict."""
    out = {}

    def walk(tree, mods):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, mods + [(k, set(v))])
                continue
            parts = []
            for i, (m, _) in enumerate(mods):
                got = re.fullmatch(r"(layers|blocks)_(\d+)", m)
                parent = mods[i - 1][1] if i else set()
                if got:
                    parts += [got.group(1), got.group(2)]
                elif m == "dwconv":
                    parts += ["dwconv", "dwconv"]
                elif m in ("conv", "norm") and parent == {"conv", "norm"}:
                    parts.append("model.0" if m == "conv" else "model.1")
                else:
                    parts.append(m)
            a = np.asarray(v)
            if k == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T[:, :,
                                                                   None]
            leaf = {"kernel": "weight", "scale": "weight"}.get(k, k)
            out[".".join(parts + [leaf])] = torch.from_numpy(a.copy())

    walk(params, [])
    return out


ALT = [
    ("channel_attention", lambda: jax_ab.ChannelAttention(
        16, dtype=jnp.float32), lambda: ab.ChannelAttention(12, 16), 12, {}),
    ("sparse_dense", lambda: jax_ab.SparseDenseBlock(
        24, mid_channels=16, num_layers=3, dtype=jnp.float32),
     lambda: ab.SparseDenseBlock(16, 24, 16, 3), 16, {}),
    ("sparse_dense_final", lambda: jax_ab.SparseDenseBlock(
        24, mid_channels=16, num_layers=2, as_final_block=True,
        dtype=jnp.float32),
     lambda: ab.SparseDenseBlock(16, 24, 16, 2, True), 16, {}),
    ("resblock", lambda: jax_ab.ResBlock(24, mid_channels=16,
                                         dtype=jnp.float32),
     lambda: ab.ResBlock(16, 24, 16), 16, {}),
    ("resblock_dense", lambda: jax_ab.ResBlock(
        24, mid_channels=16, dense=True, dtype=jnp.float32),
     lambda: ab.ResBlock(16, 24, 16, dense=True), 16, {}),
    ("resblock_final", lambda: jax_ab.ResBlock(
        24, mid_channels=16, as_final_block=True, dtype=jnp.float32),
     lambda: ab.ResBlock(16, 24, 16, as_final_block=True), 16, {}),
    ("acti", lambda: jax_ab.Acti(2, dtype=jnp.float32),
     lambda: ab.Acti(8, 2), 8, {}),
    ("conv_attention", lambda: jax_ab.ConvAttention(
        16, embed_dim=32, num_heads=2, num_blocks=1, divisor=16,
        dtype=jnp.float32),
     lambda: ab.ConvAttention(8, 16, embed_dim=32, num_heads=2,
                              num_blocks=1, divisor=16), 8,
     {"deterministic": True}),
]


def _alt_input(name, cin):
    hw = (16, 32) if name == "conv_attention" else (8, 12)
    return np.random.default_rng(5).standard_normal(
        (2, *hw, cin)).astype(np.float32)


@pytest.mark.parametrize("name,jax_block,port_block,cin,kw", ALT,
                         ids=[a[0] for a in ALT])
def test_alt_block_matches_jax(jax_refs, name, jax_block, port_block, cin,
                               kw):
    want, params = jax_refs(name)
    block = port_block()
    block.load_state_dict(_port_state(params), strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(_alt_input(name, cin))).numpy()
    assert got.shape == want.shape
    # atol 1e-6 at the output's scale: the blocks' GroupNorms leave O(1)
    # outputs a few fp32 ulps from the float64 truth in either framework
    # (JAX's own jit and eager runs of sparse_dense differ by 1.7e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * max(1.0, np.abs(want).max()))


def test_unpool_matches_jax():
    x = np.random.default_rng(6).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(ab.unpool_x2(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_ab.unpool_x2(
                                      jnp.asarray(x))))


# -- Lucas-Kanade -------------------------------------------------------------


@pytest.mark.parametrize("case", ["translation", "identity", "rgb"])
def test_lk_flow_matches_jax(jax_refs, case):
    im1, im2 = _lk_cases()[case]
    got = lk_flow(im1, im2, device="cpu")
    np.testing.assert_allclose(got, jax_refs(case)[0], atol=1e-4)
    if case == "translation":
        assert abs(np.median(got[16:-16, 16:-16, 0]) + 3) < 0.5
        assert abs(np.median(got[16:-16, 16:-16, 1]) + 2) < 0.5
