"""The port's rematerialization and microbatch padding, on the CPU
(beside tests/test_torch_train.py, whose JAX train steps they do not
need; a file of 8 or fewer tests queues behind the suite's longest file
under ``--dist loadfile``).

Remat: the gradients with each ``remat_*`` option equal those without it
bit for bit, with dropout on (drop path 0.1, Dropout2d 0.2) drawn from one
generator seed; ``remat_decoder`` recomputes the seg and TPUDecoder stages
too. Padding: a microbatch padded with dummy rows gives the unpadded
loss (rtol 1e-6) and gradients (rtol 1e-4, atol 1e-7), the seg labels of
the padded rows 255.
"""

import dataclasses

import numpy as np
import pytest
import torch

from camradepth_tpu_torch.config import tiny_test_config
from camradepth_tpu_torch.models.camradepth import create_model
from camradepth_tpu_torch.train.diffgrad import DiffGradNorm
from camradepth_tpu_torch.train.step import pad_microbatch, train_step
from tests.test_torch_train import HW, SEG, SEG_TRAIN, _microbatches
from tests.torch_port import one_torch_thread  # noqa: F401


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


def test_remat_decoder_covers_the_seg_and_tpu_decoder_stages():
    """sup_unsup_seg with tpu_decoder: remat_decoder recomputes the seg
    and TPUDecoder stages too, and gives the gradients of no remat bit for
    bit, with dropout drawn from one generator seed."""
    micro = {k: torch.from_numpy(v[0])
             for k, v in _microbatches(11, seg=True).items()}
    cfg = _tiny_train_cfg(drop_path_rate=0.1, dropout_rate=0.2,
                          tpu_decoder=True, **SEG)
    runs = []
    for remat_decoder in (False, True):
        model = create_model(dataclasses.replace(
            cfg.model, remat_decoder=remat_decoder), device="cpu", seed=5,
            train=True)
        calls = []
        for stage in (*model.depth_upsample, *model.seg_upsample):
            # counted in forward itself: the recompute fires no hooks
            def counted(*args, stage=stage, forward=stage.forward):
                calls.append(type(stage).__name__)
                return forward(*args)

            stage.forward = counted
        gen = torch.Generator().manual_seed(7)
        metrics = train_step(cfg, model, DiffGradNorm(model.parameters(),
                                                      lr=0.0),
                             [micro], [gen], 0.0)
        runs.append((metrics, {k: p.grad.clone()
                               for k, p in model.named_parameters()},
                     sorted(calls)))
    (m0, g0, c0), (m1, g1, c1) = runs
    # each of the 7 stages runs once, and again in the backward with remat
    assert c0 == sorted(["Decoder"] * 3 + ["TPUDecoder"] * 4)
    assert c1 == sorted(c0 * 2)
    assert m0["loss"] == m1["loss"] and float(m0["loss_seg_final"]) > 0
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


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


def test_padded_seg_microbatch_gives_the_unpadded_gradients():
    """sup_unsup_seg with the stage-4 seg loss: the padded rows' seg and
    seg_inter labels are 255, which the focal loss ignores."""
    micro = {k: torch.from_numpy(v[0])
             for k, v in _microbatches(10, seg=True).items()}
    cfg = _tiny_train_cfg(dropout_rate=0.0, **SEG)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **SEG_TRAIN))
    m0, g0 = _grads(cfg, micro, 0)
    padded = cfg.replace(train=dataclasses.replace(cfg.train,
                                                   pad_microbatch_to=3))
    m1, g1 = _grads(padded, micro, 0)
    assert float(m0["loss_seg_final"]) > 0 and float(m0["loss_seg_inter"]) > 0
    for k in ("loss", "loss_seg_final", "loss_seg_inter"):
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-6,
                                   err_msg=k)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-4, atol=1e-7)
