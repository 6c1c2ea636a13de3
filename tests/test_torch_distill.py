"""The port's distillation (camradepth_tpu_torch.train.distill, ``cli
distill``) against the JAX package's (camradepth_tpu.train.distill), on
the CPU.

- ``distill_terms``: the same random predictions through both, at
  temperature 1 and 2, with and without seg heads; fp32, rtol 1e-6.
- One distill step against ``make_distill_step``: a supervised_seg +
  tpu_decoder student and a supervised_seg parity teacher at 32x64,
  fp32, alpha 0.5, temperature 2, update_interval 2, each microbatch of 2
  padded to 3, dropout off. Held to the fp32 train-step limits of
  tests/test_torch_train.py: every loss term and grad_norm rtol 1e-5,
  each gradient relative L2 1e-4, after the step at most 0.1 % of the
  elements past 1e-3 * lr and none past 2 * lr. The argmax guidance maps
  of both models feed their depth heads, and a pixel within the
  frameworks' roundoff of a tie would flip and change the step, not the
  code: the microbatches are seeded (SEED) so that every guidance pixel of
  both models, padded rows included, has its two largest logits more than
  twice the frameworks' largest logit difference apart, which the test
  asserts first.
- The warm start: the port's ``partial_restore`` transfers the parameter
  set of JAX's ``partial_restore_params`` (mapped through
  ``interop/flax_convert``), at the tiny widths and at `base`'s published
  widths, where its count is the one chip_smoke.py holds the card's
  ``cli distill`` to.

The trainer's storage and argument checks are in
tests/test_torch_distill_trainer.py, ``cli distill`` end to end and its
refusals in tests/test_torch_distill_cli.py.

The JAX step and forwards are compiled only by the test that needs them,
on a pool of threads while the port computes its side.
"""

import concurrent.futures
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from camradepth_tpu.config import preset as jax_preset
from camradepth_tpu.models.camradepth import CamRaDepth as JaxCamRaDepth
from camradepth_tpu.train import distill as jax_distill
from camradepth_tpu.train.diffgrad import diffgrad_norm
from camradepth_tpu.train.schedule import onecycle as jax_onecycle
from camradepth_tpu.train.step import TrainState
from camradepth_tpu.utils.checkpoint import partial_restore_params
from camradepth_tpu_torch.config import preset as port_preset
from camradepth_tpu_torch.config import tiny_test_config
from camradepth_tpu_torch.interop.flax_convert import (
    _flax_path_to_torch_key,
    state_dict_from_flax,
)
from camradepth_tpu_torch.models.camradepth import create_model
from camradepth_tpu_torch.train import distill
from camradepth_tpu_torch.train.diffgrad import DiffGradNorm
from camradepth_tpu_torch.train.schedule import onecycle
from camradepth_tpu_torch.train.step import train_step
from camradepth_tpu_torch.utils import checkpoint as ckpt_util
from tests.test_torch_train import (
    ACCUM,
    HW,
    LR,
    TOTAL,
    _flax_params,
    _jax_cfg,
    _microbatches,
    _port_cfg,
    check_step,
)
from tests.torch_port import one_torch_thread  # noqa: F401

ALPHA, TEMPERATURE, PAD_TO = 0.5, 2.0, 3
# the step's microbatch seed, the first from 0 whose guidance pixels lie
# away from ties (see the module docstring; at seed 4 one guidance pixel
# lay 4.7e-4 of the logit difference from a tie)
SEED = 0
DISTILL_TERMS = ("loss", "loss_distill", "loss_gt", "rmse_m", "grad_norm",
                 "distill_depth_final", "distill_depth_stage4",
                 "distill_depth_stage3", "distill_seg_final",
                 "distill_seg_inter")
TINY_FLAGS = ["--set", "model.img_size=32,64", "--set",
              "model.dims=16,32,32,64", "--set", "model.ff_expansion=2,2,2,2",
              "--set", "model.depths=1,1,1,1", "--set",
              "model.mid_channels=32", "--set", "data.image_dimension=32,64",
              "--set", "data.num_workers=2"]


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """The metric writer without TensorBoard (its import pulls in
    TensorFlow, ~17 s), as in tests/test_torch_trainer.py."""
    saved = sys.modules.get("tensorboard", False)
    sys.modules["tensorboard"] = None  # import raises ImportError
    yield
    if saved is False:
        del sys.modules["tensorboard"]
    else:
        sys.modules["tensorboard"] = saved


def _preds(rng, seg, b=2, h=8, w=16, c=5):
    def a(*shape):
        return rng.uniform(-0.2, 1.2, (b,) + shape).astype(np.float32)

    return {"depth": {"final_depth": a(h, w, 1),
                      "intermediate_depths": (None, None,
                                              a(h // 4, w // 4, 1),
                                              a(h // 2, w // 2, 1))},
            "seg": {"final_seg": 3 * a(h, w, c) if seg else None,
                    "intermediate_seg": (3 * a(h // 2, w // 2, c) if seg
                                         else None),
                    "unsup_map": None}}


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree(v, fn) for v in tree)
    return None if tree is None else fn(tree)


@pytest.mark.parametrize("seg", [False, True])
@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_distill_terms_match_jax(temperature, seg):
    rng = np.random.default_rng(int(temperature) + 2 * seg)
    student, teacher = _preds(rng, seg), _preds(rng, seg)
    total, terms = distill.distill_terms(
        _tree(student, torch.from_numpy), _tree(teacher, torch.from_numpy),
        tiny_test_config(), temperature)
    want_total, want_terms = jax_distill.distill_terms(
        _tree(student, jnp.asarray), _tree(teacher, jnp.asarray),
        jax_preset("base"), temperature)
    np.testing.assert_allclose(total.numpy(), np.asarray(want_total),
                               rtol=1e-6)
    assert sorted(terms) == sorted(want_terms)
    for k, v in want_terms.items():
        np.testing.assert_allclose(float(terms[k]), float(v), rtol=1e-6,
                                   err_msg=k)
    assert (float(terms["distill_seg_final"]) > 0) == seg


def _step_cfgs(framework):
    """(student, teacher) configs of the step: supervised_seg, fp32,
    dropout off, microbatches padded to 3; the student tpu_decoder."""
    make = _jax_cfg if framework == "jax" else _port_cfg
    student = make("float32", supervised_seg=True, tpu_decoder=True)
    student = student.replace(train=dataclasses.replace(
        student.train, seg_inter_loss=False, pad_microbatch_to=PAD_TO))
    teacher = student.replace(model=dataclasses.replace(
        student.model, tpu_decoder=False))
    return student, teacher


def _padded(features):
    """[ACCUM, 2, ...] features -> the padded rows the models see."""
    pad = np.zeros((ACCUM, PAD_TO - 2) + features.shape[2:], np.float32)
    return np.concatenate([features, pad], axis=1).reshape(
        -1, *features.shape[2:])


def _port_models(student_cfg, teacher_cfg, sparams, tparams):
    def sd(params):
        return {k: np.ascontiguousarray(v)
                for k, v in state_dict_from_flax(params).items()}

    return (create_model(student_cfg.model, device="cpu", train=True,
                         state_dict=sd(sparams)),
            create_model(teacher_cfg.model, device="cpu",
                         state_dict=sd(tparams)))


@pytest.fixture(scope="module")
def step():
    """One distill step of JAX and of the port from the same parameters
    and microbatches, and both frameworks' seg logits (final, stage 4) of
    both models on the padded microbatches."""
    (jstudent, jteacher), (pstudent, pteacher) = (_step_cfgs("jax"),
                                                  _step_cfgs("port"))
    smodel, tmodel = (JaxCamRaDepth(jstudent.model),
                      JaxCamRaDepth(jteacher.model))
    x0 = jnp.zeros((1, *HW, 7))
    sparams = _flax_params(smodel, x0, seed=1)
    tparams = _flax_params(tmodel, x0, seed=2)
    micro = _microbatches(SEED, seg=True)
    tx = diffgrad_norm(jax_onecycle(LR, total_steps=TOTAL, div_factor=2.0))
    rng = jax.random.PRNGKey(3)
    lr = onecycle(LR, TOTAL, div_factor=2.0)(0)
    feats = _padded(micro["features"])

    def seg_logits(sp, tp, x):
        out = {}
        for name, model, p in (("student", smodel, sp),
                               ("teacher", tmodel, tp)):
            seg = model.apply({"params": p}, x, deterministic=True)["seg"]
            out[name] = (seg["final_seg"], seg["intermediate_seg"])
        return out

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        state = TrainState(jax.tree.map(jnp.asarray, sparams),
                           jax.jit(tx.init)(sparams),
                           jnp.zeros([], jnp.int32))
        jmicro = {k: jnp.asarray(v) for k, v in micro.items()}
        step_fn = jax_distill.make_distill_step(
            jstudent, smodel, tmodel, jax.tree.map(jnp.asarray, tparams), tx,
            alpha=ALPHA, temperature=TEMPERATURE)
        compiling = pool.submit(jax.jit(step_fn).lower(state, jmicro,
                                                       rng).compile)
        logits = pool.submit(jax.jit(seg_logits).lower(
            sparams, tparams, jnp.asarray(feats)).compile)
        # the port's side meanwhile
        student, teacher = _port_models(pstudent, pteacher, sparams,
                                        tparams)
        port_logits = {}
        with torch.no_grad():
            for name, model in (("student", student), ("teacher", teacher)):
                seg = model(torch.from_numpy(feats))["seg"]
                port_logits[name] = (seg["final_seg"].numpy(),
                                     seg["intermediate_seg"].numpy())
        opt = DiffGradNorm(student.parameters(), lr=lr)
        tmicro = [{k: torch.from_numpy(v[i]) for k, v in micro.items()}
                  for i in range(ACCUM)]
        loss_fn = functools.partial(distill.distill_loss, teacher=teacher,
                                    alpha=ALPHA, temperature=TEMPERATURE)
        metrics = train_step(pstudent, student, opt, tmicro, [None] * ACCUM,
                             lr, loss_fn=loss_fn)
        port = ({k: float(v) for k, v in metrics.items()},
                {k: p.grad.double().numpy()
                 for k, p in student.named_parameters()},
                {k: p.detach().double().numpy()
                 for k, p in student.named_parameters()})
        new, jmetrics = compiling.result()(state, jmicro, rng)
        jax_out = ({k: float(v) for k, v in jmetrics.items()},
                   state_dict_from_flax(new.opt_state[0].previous_grad),
                   state_dict_from_flax(new.params))
        want_logits = logits.result()(sparams, tparams, jnp.asarray(feats))
    return (jax_out, port, lr), (want_logits, port_logits)


def test_distill_step_matches_jax_make_distill_step(step):
    result, (want, got) = step
    for name in ("student", "teacher"):
        for head, w, g in zip(("final", "stage 4"), want[name], got[name]):
            w = np.asarray(w)
            assert g.shape == w.shape, (name, head)
            top2 = np.sort(w, axis=-1)[..., -2:]
            gap = float((top2[..., 1] - top2[..., 0]).min())
            diff = float(np.abs(g - w).max())
            print(f"{name} {head}: nearest tie {gap:.3g}, largest logit "
                  f"difference {diff:.3g}")
            assert gap > 2 * diff, (name, head, gap, diff)
            np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    jm, tm = result[0][0], result[1][0]
    assert sorted(tm) == sorted(jm) == sorted(DISTILL_TERMS)
    assert jm["distill_seg_final"] > 0 and jm["distill_seg_inter"] > 0
    check_step(result, 1e-5, 1e-5, 1e-4, 1e-4, 1e-3,
               step_terms=DISTILL_TERMS)


def _jax_transferred(teacher_model_cfg, student_model_cfg):
    """The port keys of the student parameters that JAX's warm start
    (``partial_restore_params``) takes from the teacher, and the
    student's parameter count; shapes from ``jax.eval_shape``."""
    def zeros(model_cfg):
        x = jnp.zeros((1, *model_cfg.img_size, model_cfg.input_channels))
        model = JaxCamRaDepth(model_cfg)
        shapes = jax.eval_shape(lambda k: model.init(
            {"params": k}, x, deterministic=True), jax.random.PRNGKey(0))
        return jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                            shapes["params"])

    teacher, student = zeros(teacher_model_cfg), zeros(student_model_cfg)
    _, mismatches = partial_restore_params(teacher, student, verbose=False)
    skipped = {k for k, _ in mismatches}
    flat, _ = jax.tree_util.tree_flatten_with_path(student)
    keys = ["/".join(str(p.key) for p in path) for path, _ in flat]
    return ({_flax_path_to_torch_key(k.split("/")) for k in keys
             if k not in skipped}, len(keys), teacher)


def _port_transferred(teacher_flax, student_model_cfg):
    student = create_model(student_model_cfg, device="cpu", train=True)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in state_dict_from_flax(teacher_flax).items()}
    done = ckpt_util.partial_restore(sd, student, verbose=False)
    return set(done.transferred), done.total


@pytest.mark.parametrize("widths,seg", [("tiny", False), ("tiny", True),
                                        ("base", False)])
def test_warm_start_transfers_the_jax_parameter_set(widths, seg):
    """At `base`'s widths the count is chip_smoke's DISTILL_WARM_START
    (param shapes do not depend on the image size, so 64x128 serves)."""
    from camradepth_tpu.config import tiny_test_config as jax_tiny

    model = (jax_tiny().model if widths == "tiny" else dataclasses.replace(
        jax_preset("base").model, img_size=(64, 128)))
    teacher = dataclasses.replace(model, supervised_seg=seg)
    student = dataclasses.replace(teacher, tpu_decoder=True)
    want, total, teacher_flax = _jax_transferred(teacher, student)
    port_model = (tiny_test_config().model if widths == "tiny"
                  else port_preset("base").model)
    got, port_total = _port_transferred(teacher_flax, dataclasses.replace(
        port_model, img_size=model.img_size, supervised_seg=seg,
        tpu_decoder=True))
    assert got == want and port_total == total
    # the subpixel stages and heads keep their init
    assert not any(k.startswith("depth_upsample.3") for k in got)
    if widths == "base":
        assert (len(got), total) == chip_smoke.DISTILL_WARM_START
