"""One train step of the port against ``camradepth_tpu.train.step.
make_train_step``, on the CPU, in fp32 and in bf16, and the port's
rematerialization and microbatch padding.

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
  round every op to bf16, but not at the same places (XLA:CPU evaluates
  some elementwise chains and reductions in fp32, torch's CPU convolutions
  run in fp32 and round their output), so the step is held to limits set
  from what was measured on this CPU (measured in brackets): loss terms
  rtol 2e-3 (1.4e-4 to 5.8e-4); grad_norm rtol 1e-2 (1.2e-3); all
  gradients together, relative L2 5e-2 (1.6e-2); each parameter's
  gradient, relative L2 1.0 (up to 0.53, at the depth heads' biases: sums
  over every pixel of bf16 cotangents that nearly cancel, where a few bf16
  roundings move the small sum by half its size; the encoder's weights
  stay below 0.11); the parameters after the step: none past 2 * lr
  (0.998 * lr: the sign-like step flips wherever the two gradients' signs
  differ), at most 20 % of the elements past 1e-3 * lr (10.1 %).
Remat: the gradients with each ``remat_*`` option equal those without it
bit for bit, with dropout on (drop path 0.1, Dropout2d 0.2) drawn from one
generator seed.
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
from camradepth_tpu.train.diffgrad import diffgrad_norm
from camradepth_tpu.train.schedule import onecycle as jax_onecycle
from camradepth_tpu.train.step import TrainState, make_train_step
from camradepth_tpu_torch.config import tiny_test_config
from camradepth_tpu_torch.interop.flax_convert import state_dict_from_flax
from camradepth_tpu_torch.models.camradepth import create_model
from camradepth_tpu_torch.train.diffgrad import DiffGradNorm
from camradepth_tpu_torch.train.schedule import onecycle
from camradepth_tpu_torch.train.step import pad_microbatch, train_step
from tests.torch_port import one_torch_thread  # noqa: F401

HW = (32, 64)
ACCUM = 2
LR, TOTAL = 1e-3, 10


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


def _microbatches(seed):
    rng = np.random.default_rng(seed)
    h, w = HW
    feats = rng.standard_normal((ACCUM, 2, h, w, 7)).astype(np.float32)
    gt = rng.uniform(0.01, 1.0, (ACCUM, 2, h, w)).astype(np.float32)
    gt *= (rng.uniform(size=gt.shape) < 0.3)
    return {"features": feats, "gt_depth": gt}


def _jax_cfg(dtype):
    jcfg = jax_tiny_config()
    return jcfg.replace(model=dataclasses.replace(
        jcfg.model, img_size=HW, compute_dtype=dtype, dropout_rate=0.0))


def _port_step(dtype, params, micro, lr):
    """The port's step from the same parameters and microbatches:
    (metrics, gradients, parameters after the step)."""
    cfg = tiny_test_config()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, img_size=HW, compute_dtype=dtype, dropout_rate=0.0))
    model = create_model(cfg.model, device="cpu", train=True, state_dict={
        k: np.ascontiguousarray(v)
        for k, v in state_dict_from_flax(params).items()})
    opt = DiffGradNorm(model.parameters(), lr=lr)
    tmicro = [{k: torch.from_numpy(v[i]) for k, v in micro.items()}
              for i in range(ACCUM)]
    metrics = train_step(cfg, model, opt, tmicro, [None] * ACCUM, lr)
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.grad.double().numpy() for k, p in model.named_parameters()},
            {k: p.detach().double().numpy()
             for k, p in model.named_parameters()})


@pytest.fixture(scope="module")
def steps():
    """{dtype: (JAX step: metrics, grads, params after; port step: the
    same; lr)} for one step of update_interval 2. Each JAX step is compiled
    on a thread of its own as soon as it is traced (XLA's compile releases
    the interpreter lock), so the next trace and the port's steps run
    meanwhile."""
    dtypes = ("bfloat16", "float32")  # the longer compile first
    models = {dt: JaxCamRaDepth(_jax_cfg(dt).model) for dt in dtypes}
    params = _flax_params(models["float32"], jnp.zeros((1, *HW, 7)), seed=1)
    tx = diffgrad_norm(jax_onecycle(LR, total_steps=TOTAL, div_factor=2.0))
    state = TrainState(jax.tree.map(jnp.asarray, params),
                       jax.jit(tx.init)(params), jnp.zeros([], jnp.int32))
    micro = _microbatches(2)
    jmicro = {k: jnp.asarray(v) for k, v in micro.items()}
    rng = jax.random.PRNGKey(3)
    lr = onecycle(LR, TOTAL, div_factor=2.0)(0)
    with concurrent.futures.ThreadPoolExecutor(len(dtypes)) as pool:
        compiling = {}
        for dt in dtypes:
            lowered = jax.jit(make_train_step(_jax_cfg(dt), models[dt], tx)
                              ).lower(state, jmicro, rng)
            compiling[dt] = pool.submit(lowered.compile)
        port = {dt: _port_step(dt, params, micro, lr) for dt in dtypes}
        out = {}
        for dt in dtypes:
            new, metrics = compiling[dt].result()(state, jmicro, rng)
            jax_out = ({k: float(v) for k, v in metrics.items()},
                       state_dict_from_flax(new.opt_state[0].previous_grad),
                       state_dict_from_flax(new.params))
            out[dt] = (jax_out, port[dt], lr)
    return out


def check_step(step, loss_rtol, norm_rtol, grad_rel, global_rel, share):
    """Hold the port's step to the JAX step: the loss terms, grad_norm,
    each parameter's gradient (relative L2), all gradients together
    (relative L2) and the parameters after the step (at most ``share`` of
    the elements past 1e-3 * lr, none past 2 * lr)."""
    (jm, jg, jp), (tm, tg, tp), lr = step
    for k in ("loss", "loss_depth_final", "loss_depth_stage4",
              "loss_depth_stage3", "rmse_m"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=loss_rtol, err_msg=k)
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                               rtol=norm_rtol)
    assert sorted(tg) == sorted(jg)
    for k, want in jg.items():
        want = np.asarray(want, np.float64)
        rel = np.linalg.norm(tg[k] - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= grad_rel, (k, rel)
    want = np.concatenate([np.asarray(jg[k], np.float64).ravel() for k in jg])
    got = np.concatenate([tg[k].ravel() for k in jg])
    assert np.linalg.norm(got - want) <= global_rel * np.linalg.norm(want)
    diffs = np.concatenate([np.abs(tp[k] - np.asarray(v, np.float64)).ravel()
                            for k, v in jp.items()])
    assert diffs.max() <= 2 * lr, diffs.max()
    assert np.mean(diffs > 1e-3 * lr) <= share, np.mean(diffs > 1e-3 * lr)


def test_fp32_step_matches_jax_make_train_step(steps):
    check_step(steps["float32"], 1e-5, 1e-5, 1e-4, 1e-4, 1e-3)


def test_bf16_step_matches_jax_make_train_step(steps):
    check_step(steps["bfloat16"], 2e-3, 1e-2, 1.0, 5e-2, 0.2)


def _tiny_train_cfg(**model_kw):
    cfg = tiny_test_config()
    return cfg.replace(model=dataclasses.replace(
        cfg.model, img_size=HW, **model_kw))


def _grads(cfg, micro, seed):
    """Gradients of one microbatch in train mode, dropout from a generator
    seeded with ``seed``."""
    model = create_model(cfg.model, device="cpu", seed=5, train=True)
    opt = DiffGradNorm(model.parameters(), lr=0.0)
    gen = torch.Generator().manual_seed(seed)
    metrics = train_step(cfg, model, opt, [micro], [gen], 0.0)
    return metrics, {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("option", ["remat_encoder", "remat_decoder",
                                    "remat_decoder_small"])
def test_remat_gives_the_gradients_of_no_remat(option):
    micro = {k: torch.from_numpy(v[0]) for k, v in _microbatches(6).items()}
    base = _tiny_train_cfg(drop_path_rate=0.1, dropout_rate=0.2)
    m0, g0 = _grads(base, micro, 7)
    m1, g1 = _grads(base.replace(model=dataclasses.replace(
        base.model, **{option: True})), micro, 7)
    assert m0["loss"] == m1["loss"]
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    # dropout was drawn: another seed gives another loss
    m2, _ = _grads(base, micro, 8)
    assert m2["loss"] != m0["loss"]


def test_padded_microbatch_gives_the_unpadded_gradients():
    micro = {k: torch.from_numpy(v[0]) for k, v in _microbatches(9).items()}
    cfg = _tiny_train_cfg(dropout_rate=0.0)
    m0, g0 = _grads(cfg, micro, 0)
    padded = cfg.replace(train=dataclasses.replace(cfg.train,
                                                   pad_microbatch_to=3))
    m1, g1 = _grads(padded, micro, 0)
    np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]),
                               rtol=1e-6)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-4, atol=1e-7)
    p = pad_microbatch({"gt_depth": micro["gt_depth"],
                        "seg": torch.zeros(2, 4, dtype=torch.int32)}, 3)
    assert p["gt_depth"].shape[0] == 3 and not p["gt_depth"][2].any()
    assert (p["seg"][2] == 255).all()
