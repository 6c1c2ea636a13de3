"""One train step of the port against ``camradepth_tpu.train.step.
make_train_step``, on the CPU, in fp32 and in bf16.

The JAX step runs at tiny widths (``tiny_test_config``, frames cut to
32x64 to keep its CPU time down) with dropout off, update_interval 2; its
parameters come across through ``interop/flax_convert.state_dict_from_flax``
and both sides take the same numpy-seeded microbatches. The JAX step's
averaged gradients are read from its optimizer state (diffGradNorm's
``previous_grad`` is the raw gradient of the step). The two dtypes' XLA
compiles (~13 s each) run side by side on two threads. Tolerances:
- fp32: loss and grad_norm rtol 1e-5; each parameter's gradient relative
  L2 error 1e-4 (two frameworks summing convs, norms and losses in other
  orders). The parameters after the step: diffGrad is sign-like (its
  update is about lr * sign(g) wherever exp_avg_sq is still tiny), so
  roundoff in a near-zero gradient flips a whole lr-sized step; at most
  0.1 % of the elements may differ by more than 1e-3 * lr, and none by
  more than 2 * lr;
- bf16 (fp32 params, gradients and optimizer state on both sides): both
  round every op to bf16 at the same places where the port can see them
  (the convolutions' and dense layers' biases are added after the
  product is rounded; the depth heads' sigmoid is four rounded operations
  and their last add is left in fp32, as XLA compiles them), but XLA:CPU
  evaluates some elementwise chains and every reduction its own way, so
  the step is held to limits set from what was measured on this CPU and
  printed by check_step (in brackets): loss terms rtol 2e-3 (3.5e-4 to
  8.4e-4); grad_norm rtol 1e-2 (2.2e-5); all
  gradients together, relative L2 5e-2 (1.7e-2); each parameter's
  gradient, relative L2 0.75, which a zeroed gradient (1.0) fails (up to
  0.53, at the depth heads' biases: XLA:CPU sums their pixels in bf16, rounding after every add,
  and the sums nearly cancel; the port's lie within 0.3 % of its fp32
  step's gradients, the JAX ones 1.1 to 35 % from them
  (test_bf16_head_bias_gradients_follow_the_fp32_step), and
  test_depth_head_bias_gradients_match_flax shows it on one head; outside
  the heads up to 0.26, at stage 3, whose 2 keys per token at 32x64 make
  a max-pool argmax flip move a whole row of gradient); the
  parameters after the step: none past 2 * lr (0.9994 * lr: the sign-like
  step flips wherever the two gradients' signs differ), at most 20 % of
  the elements past 1e-3 * lr (10.1 %).
The seg step: sup_unsup_seg in fp32 with the stage-4 seg loss on, its
JAX step compiled on a third thread beside the two above. The argmax
guidance maps that feed the depth heads (stage-4 and final, supervised and
unsupervised) must first agree pixel for pixel with the JAX forward's: a
near-tie pixel that flipped would change the step, not the code under
test. So the step's microbatches are seeded (SEG_SEED, the first seed from
2 that qualifies) so that no guidance pixel's two largest logits lie
within twice the two frameworks' largest logit difference, which the test
asserts before the maps (at seed 2 one unsup_final pixel lay 1.7e-6 from
a tie, and it flipped). Then the fp32 limits above, and rtol 1e-5 for
loss_seg_final and loss_seg_inter.
The remat and padding tests are in tests/test_torch_train_grads.py.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camradepth_tpu.config import tiny_test_config as jax_tiny_config
from camradepth_tpu.models.camradepth import CamRaDepth as JaxCamRaDepth
from camradepth_tpu.models.layers import DepthActivation as JaxDepthActivation
from camradepth_tpu.train.diffgrad import diffgrad_norm
from camradepth_tpu.train.schedule import onecycle as jax_onecycle
from camradepth_tpu.train.step import TrainState, make_train_step
from camradepth_tpu_torch.config import tiny_test_config
from camradepth_tpu_torch.interop.flax_convert import state_dict_from_flax
from camradepth_tpu_torch.models.camradepth import create_model
from camradepth_tpu_torch.models.layers import DepthActivation
from camradepth_tpu_torch.train.diffgrad import DiffGradNorm
from camradepth_tpu_torch.train.schedule import onecycle
from camradepth_tpu_torch.train.step import train_step
from tests.torch_port import one_torch_thread  # noqa: F401

HW = (32, 64)
ACCUM = 2
LR, TOTAL = 1e-3, 10
# check_step's limits of the bf16 step (see the module docstring)
BF16_LIMITS = dict(loss_rtol=2e-3, norm_rtol=1e-2, grad_rel=0.75,
                   global_rel=5e-2, share=0.2)
BF16_U = 2.0 ** -8  # bf16's unit roundoff


def _flax_params(model, x, seed):
    """Parameters of the JAX model: the tree and shapes of its init (traced
    by jax.eval_shape), values from numpy: norm scales near 1, small
    biases, kernels ~ N(0, 1/fan_in)."""
    shapes = jax.eval_shape(
        lambda key: model.init({"params": key}, x, deterministic=True),
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


# the seg step's model and train options
SEG = dict(supervised_seg=True, unsupervised_seg=True)
SEG_TRAIN = dict(seg_inter_loss=True)
# the seg step's microbatch seed (see the module docstring)
SEG_SEED = 5
# the guidance maps' heads, whose argmax feeds the depth heads
GUIDANCE_HEADS = ("seg_conv_stage_4", "unsup_stage_4", "seg_conv_final",
                  "unsup_final")


def _microbatches(seed, seg=False):
    rng = np.random.default_rng(seed)
    h, w = HW
    feats = rng.standard_normal((ACCUM, 2, h, w, 7)).astype(np.float32)
    gt = rng.uniform(0.01, 1.0, (ACCUM, 2, h, w)).astype(np.float32)
    gt *= (rng.uniform(size=gt.shape) < 0.3)
    out = {"features": feats, "gt_depth": gt}
    if seg:
        # 21 classes and a 255 (ignored) share
        for key, shape in (("seg", (h, w)), ("seg_inter", (h // 2, w // 2))):
            lab = rng.integers(0, 21, (ACCUM, 2) + shape).astype(np.int32)
            lab[rng.uniform(size=lab.shape) < 0.1] = 255
            out[key] = lab
    return out


def _jax_cfg(dtype, **model_kw):
    jcfg = jax_tiny_config()
    return jcfg.replace(
        model=dataclasses.replace(jcfg.model, img_size=HW,
                                  compute_dtype=dtype, dropout_rate=0.0,
                                  **model_kw),
        train=dataclasses.replace(jcfg.train,
                                  **(SEG_TRAIN if model_kw else {})))


def _port_cfg(dtype, **model_kw):
    cfg = tiny_test_config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, img_size=HW,
                                  compute_dtype=dtype, dropout_rate=0.0,
                                  **model_kw),
        train=dataclasses.replace(cfg.train,
                                  **(SEG_TRAIN if model_kw else {})))


def _port_model(cfg, params):
    return create_model(cfg.model, device="cpu", train=True, state_dict={
        k: np.ascontiguousarray(v)
        for k, v in state_dict_from_flax(params).items()})


def _port_step(dtype, params, micro, lr, **model_kw):
    """The port's step from the same parameters and microbatches:
    (metrics, gradients, parameters after the step)."""
    cfg = _port_cfg(dtype, **model_kw)
    model = _port_model(cfg, params)
    opt = DiffGradNorm(model.parameters(), lr=lr)
    tmicro = [{k: torch.from_numpy(v[i]) for k, v in micro.items()}
              for i in range(ACCUM)]
    metrics = train_step(cfg, model, opt, tmicro, [None] * ACCUM, lr)
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.grad.double().numpy() for k, p in model.named_parameters()},
            {k: p.detach().double().numpy()
             for k, p in model.named_parameters()})


def _port_guidance(params, features):
    """The logits of the port's guidance heads on ``features``."""
    model = _port_model(_port_cfg("float32", **SEG), params)
    seen = {}
    for name in GUIDANCE_HEADS:
        getattr(model, name).register_forward_hook(
            lambda mod, args, y, name=name: seen.__setitem__(name, y))
    with torch.no_grad():
        model(torch.from_numpy(features))
    return {k: v.numpy() for k, v in seen.items()}


@pytest.fixture(scope="module")
def steps():
    """{dtype: (JAX step: metrics, grads, params after; port step: the
    same; lr)} for one step of update_interval 2. Each JAX step is compiled
    on a thread of its own as soon as it is traced (XLA's compile releases
    the interpreter lock), so the next trace and the port's steps run
    meanwhile."""
    # the longer compiles first; "seg" is sup_unsup_seg in fp32
    cases = {"bfloat16": ("bfloat16", {}), "seg": ("float32", SEG),
             "float32": ("float32", {})}
    cfgs = {c: _jax_cfg(dt, **kw) for c, (dt, kw) in cases.items()}
    models = {c: JaxCamRaDepth(cfgs[c].model) for c in cases}
    x0 = jnp.zeros((1, *HW, 7))
    params = {c: _flax_params(models[c], x0, seed=1)
              for c in ("float32", "seg")}
    params["bfloat16"] = params["float32"]
    tx = diffgrad_norm(jax_onecycle(LR, total_steps=TOTAL, div_factor=2.0))
    micro = {c: _microbatches(SEG_SEED, seg=True) if c == "seg"
             else _microbatches(2) for c in cases}
    rng = jax.random.PRNGKey(3)
    lr = onecycle(LR, TOTAL, div_factor=2.0)(0)
    with concurrent.futures.ThreadPoolExecutor(len(cases) + 1) as pool:
        compiling, states, jmicro = {}, {}, {}
        for c in cases:
            states[c] = TrainState(jax.tree.map(jnp.asarray, params[c]),
                                   jax.jit(tx.init)(params[c]),
                                   jnp.zeros([], jnp.int32))
            jmicro[c] = {k: jnp.asarray(v) for k, v in micro[c].items()}
            lowered = jax.jit(make_train_step(cfgs[c], models[c], tx)
                              ).lower(states[c], jmicro[c], rng)
            compiling[c] = pool.submit(lowered.compile)
        # the JAX forward of the seg step's microbatches, with the stage-4
        # unsupervised logits, which the outputs do not hold
        feats = micro["seg"]["features"].reshape(-1, *HW, 7)
        guidance = pool.submit(jax.jit(lambda p, v: models["seg"].apply(
            {"params": p}, v, capture_intermediates=lambda mod, _: (
                mod.name in GUIDANCE_HEADS))).lower(
                    params["seg"], jnp.asarray(feats)).compile)
        port = {c: _port_step(dt, params[c], micro[c], lr, **kw)
                for c, (dt, kw) in cases.items()}
        port_guidance = _port_guidance(params["seg"], feats)
        out = {}
        for c in cases:
            new, metrics = compiling[c].result()(states[c], jmicro[c], rng)
            jax_out = ({k: float(v) for k, v in metrics.items()},
                       state_dict_from_flax(new.opt_state[0].previous_grad),
                       state_dict_from_flax(new.params))
            out[c] = (jax_out, port[c], lr)
        _, inter = guidance.result()(params["seg"], jnp.asarray(feats))
        out["guidance"] = (
            {k: np.asarray(v["__call__"][0])
             for k, v in inter["intermediates"].items()}, port_guidance)
    return out


# the metrics of a train step that check_step holds
STEP_TERMS = ("loss", "loss_depth_final", "loss_depth_stage4",
              "loss_depth_stage3", "rmse_m", "grad_norm")


def check_step(step, loss_rtol, norm_rtol, grad_rel, global_rel, share,
               extra_terms=(), step_terms=STEP_TERMS):
    """Hold the port's step to the JAX step: the loss terms
    (``step_terms`` and ``extra_terms``), grad_norm, each parameter's
    gradient (relative L2), all gradients together (relative L2) and the
    parameters after the step (at most ``share`` of the elements past
    1e-3 * lr, none past 2 * lr)."""
    (jm, jg, jp), (tm, tg, tp), lr = step
    terms = {k: abs(tm[k] - jm[k]) / abs(jm[k])
             for k in tuple(step_terms) + tuple(extra_terms)}
    assert sorted(tg) == sorted(jg)
    rels = {k: np.linalg.norm(tg[k] - np.asarray(want, np.float64))
            / max(np.linalg.norm(want), 1e-30) for k, want in jg.items()}
    want = np.concatenate([np.asarray(jg[k], np.float64).ravel() for k in jg])
    got = np.concatenate([tg[k].ravel() for k in jg])
    global_err = np.linalg.norm(got - want) / np.linalg.norm(want)
    diffs = np.concatenate([np.abs(tp[k] - np.asarray(v, np.float64)).ravel()
                            for k, v in jp.items()])
    worst = max(rels, key=rels.get)
    body = max((k for k in rels if not k.startswith("depth_activation")),
               key=rels.get)
    print(f"measured: rtol {terms}; worst parameter {worst} {rels[worst]:.3g}"
          f", outside the heads {body} {rels[body]:.3g}"
          f"; all gradients {global_err:.3g}; after the step max "
          f"{diffs.max() / lr:.4g} lr, {np.mean(diffs > 1e-3 * lr):.4g} "
          f"past 1e-3 lr")
    for k, rtol in terms.items():
        assert rtol <= (norm_rtol if k == "grad_norm" else loss_rtol), (k,
                                                                       rtol)
    for k, rel in rels.items():
        assert rel <= grad_rel, (k, rel)
    assert global_err <= global_rel, global_err
    assert diffs.max() <= 2 * lr, diffs.max()
    assert np.mean(diffs > 1e-3 * lr) <= share, np.mean(diffs > 1e-3 * lr)


def test_fp32_step_matches_jax_make_train_step(steps):
    check_step(steps["float32"], 1e-5, 1e-5, 1e-4, 1e-4, 1e-3)


def test_seg_step_matches_jax_make_train_step(steps):
    """sup_unsup_seg, fp32: the guidance maps agree, then the step."""
    want, got = steps["guidance"]
    assert sorted(got) == sorted(want) == sorted(GUIDANCE_HEADS)
    for name in GUIDANCE_HEADS:
        assert got[name].shape == want[name].shape, name
        top2 = np.sort(want[name], axis=-1)[..., -2:]
        gap = float((top2[..., 1] - top2[..., 0]).min())
        diff = float(np.abs(got[name] - want[name]).max())
        print(f"{name}: nearest tie {gap:.3g}, largest logit difference "
              f"{diff:.3g}")
        assert gap > 2 * diff, (name, gap, diff)
        np.testing.assert_array_equal(got[name].argmax(-1),
                                      want[name].argmax(-1), err_msg=name)
    (jm, _, _), (tm, _, _), _ = steps["seg"]
    assert jm["loss_seg_final"] > 0 and jm["loss_seg_inter"] > 0
    check_step(steps["seg"], 1e-5, 1e-5, 1e-4, 1e-4, 1e-3,
               extra_terms=("loss_seg_final", "loss_seg_inter"))


def test_bf16_step_matches_jax_make_train_step(steps):
    check_step(steps["bfloat16"], **BF16_LIMITS)


def test_bf16_step_rule_fails_a_zeroed_gradient(steps):
    """The per-parameter rule of the bf16 step catches a gradient that is
    missing: the port's own gradients, one bias zeroed, fail it."""
    jax_out, (tm, tg, tp), lr = steps["bfloat16"]
    key = "depth_activation_5.conv_2.bias"
    zeroed = dict(tg, **{key: np.zeros_like(tg[key])})
    with pytest.raises(AssertionError, match=key):
        check_step((jax_out, (tm, zeroed, tp), lr), **BF16_LIMITS)


def test_bf16_head_bias_gradients_follow_the_fp32_step(steps):
    """Where the bf16 step's per-parameter gap lies: at the depth heads'
    biases the port's bf16 gradients stay within 1 % of its fp32 step's
    (relative L2), and the gap to JAX's is JAX's own distance from them
    (its bf16 sums of the pixels), which is printed."""
    (_, jg, _), (_, tg, _), _ = steps["bfloat16"]
    ref = steps["float32"][1][1]
    for k in sorted(tg):
        if not (k.startswith("depth_activation") and k.endswith("bias")):
            continue
        scale = np.linalg.norm(ref[k])
        port = np.linalg.norm(tg[k] - ref[k]) / scale
        jax_ = np.linalg.norm(np.asarray(jg[k], np.float64) - ref[k]) / scale
        print(f"{k}: port {port:.4f}, JAX {jax_:.4f} from the fp32 step")
        assert port <= 0.01, (k, port)


def test_depth_head_bias_gradients_match_flax():
    """The bf16 step's largest per-parameter gap, localized: the port's
    depth head and the JAX package's, fed the same weights, the same bf16
    input and the same bf16 cotangent at the output.

    conv_1's output is bit for bit the flax ``Conv``'s (the bias added
    after the product is rounded). Each bias gradient is a sum over the
    pixels of the cotangent at its conv's output. The port's is that sum
    correctly rounded: within 1 bf16 ulp of its float64 value. XLA:CPU
    reduces the JAX one in bf16, rounding after every add, so the two may
    differ by up to u * sum(|terms|), with u = 2^-8 (measured here: 0.57 u
    sum(|terms|) at conv_1, 0.06 at conv_2; the JAX sums lie 37 and 71
    times farther from the float64 sums than the port's)."""
    rng = np.random.default_rng(21)
    b, h, w, c = 2, 16, 32, 16
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(
        np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((b, h, w, 1)).astype(
        np.float32)).to(torch.bfloat16)
    head = JaxDepthActivation(dtype=jnp.bfloat16)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    shapes = jax.eval_shape(lambda k: head.init({"params": k}, jx),
                            jax.random.PRNGKey(0))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (0.1 if path[-1].key == "bias" else
                            1.0 / np.sqrt(np.prod(leaf.shape[:-1])))
        * rng.standard_normal(leaf.shape).astype(np.float32), shapes)

    def apply(p, v):
        return head.apply({"params": p}, v, capture_intermediates=True)

    def vjp(p, v, cot):
        (out, inter), back = jax.vjp(apply, p, v, has_aux=False)
        return inter, back((cot, jax.tree.map(jnp.zeros_like, inter)))[0]

    inter, jgrad = jax.jit(vjp)(params, jx, jnp.asarray(g.float().numpy(),
                                                        jnp.bfloat16))
    port = DepthActivation(c)
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in state_dict_from_flax(params).items()})
    seen = {}

    def keep(module, args, y):
        y.retain_grad()
        seen["y1"] = y

    port.conv_1.register_forward_hook(keep)
    port(x).backward(g.float())
    y1 = seen["y1"]
    want1 = np.asarray(inter["intermediates"]["conv_1"]["__call__"][0],
                       np.float32)
    np.testing.assert_array_equal(y1.detach().float().numpy(), want1)
    for name, terms in (("conv_2", g.double().numpy().reshape(-1, 1)),
                        ("conv_1", y1.grad.double().numpy().reshape(-1, 32))):
        got = getattr(port, name).bias.grad.double().numpy()
        want = np.asarray(jgrad[name]["bias"], np.float64)
        exact = terms.sum(0)
        ulp = np.exp2(np.floor(np.log2(np.abs(exact))) - 7)
        assert (np.abs(got - exact) <= ulp).all(), name
        gap = np.abs(got - want) / (BF16_U * np.abs(terms).sum(0))
        print(f"{name}: |port - jax| <= {gap.max():.3f} u sum|terms|; "
              f"|jax - exact| / |port - exact| = "
              f"{np.abs(want - exact).sum() / np.abs(got - exact).sum():.1f}")
        assert gap.max() <= 1.0, (name, gap.max())
