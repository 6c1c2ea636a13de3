"""The port's ``cli test`` and ``cli serve`` against ``camradepth_tpu.cli
test`` and the JAX engine, on the CPU (beside tests/test_torch_eval.py
with the JAX runs they need; a file of 8 or fewer tests queues behind the
suite's longest file under ``--dist loadfile``).

``camradepth_tpu.cli test`` and the port's ``cli test --device cpu`` on
one 6-frame corpus and one reference .pth at the ``tiny_test_config``
widths in fp32; every non-timing report key agrees to rtol 1e-3, atol
1e-4 (the two forwards agree to ~1e-5 in fp32, tests/test_torch_model.py;
metrics are means over a few thousand pixels), and the same for
``--preset sup_unsup_seg``, the ``iou`` key included; its ``cli serve``
labels against the JAX engine's by agreement >= 0.995 (argmax maps:
near-tie pixels may flip between frameworks, tests/test_flagship_golden.
py:131-140). The three JAX runs start together on threads
(``jax_runs``), beside the port's.
"""

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camradepth_tpu import cli as jax_cli
from camradepth_tpu.evaluation.harness import TIMING_KEYS as JAX_TIMING_KEYS
from camradepth_tpu_torch import cli
from camradepth_tpu_torch.config import DataConfig
from camradepth_tpu_torch.data import pipeline
from camradepth_tpu_torch.evaluation.harness import TIMING_KEYS
from tests.test_torch_eval import HW, TINY_FLAGS, _tiny_pth, corpus  # noqa: F401
from tests.torch_port import one_torch_thread  # noqa: F401


def _jax_engine(pth, split):
    """The JAX engine's forward (``camradepth_tpu.serving.
    make_serving_forward``) of the tiny sup_unsup_seg ``pth`` on the
    corpus's 6 frames."""
    from camradepth_tpu.config import tiny_test_config as jax_tiny
    from camradepth_tpu.interop.torch_convert import convert_state_dict
    from camradepth_tpu.models.camradepth import CamRaDepth as JaxCamRaDepth
    from camradepth_tpu.serving import make_serving_forward

    jcfg = jax_tiny()
    jcfg = jcfg.replace(model=dataclasses.replace(
        jcfg.model, supervised_seg=True, unsupervised_seg=True))
    params = convert_state_dict({k: v.numpy() for k, v in torch.load(
        pth, weights_only=True)["state_dict"].items()})
    frames = next(iter(pipeline.make_loaders(
        DataConfig(image_dimension=HW, mini_dataset=True), batch_size=6,
        split_path=split)["test"]))["features"]
    fwd = make_serving_forward(jcfg, JaxCamRaDepth(jcfg.model))
    return {k: np.asarray(v) for k, v in jax.jit(fwd)(
        params, jnp.asarray(frames)).items()}


@pytest.fixture(scope="module")
def jax_runs(corpus):
    """The JAX package's runs that the CLI tests hold the port to, started
    together on a pool of threads at the module's first need: ``cli test``
    (base), ``cli test --preset sup_unsup_seg`` and the seg engine's
    forward. Each spends most of its time in XLA's compiler, which leaves
    the interpreter lock, so they overlap each other and the port's runs
    on the main thread. Yields the seg .pth and the three futures."""
    tmp, split, pth = corpus
    seg_pth = _tiny_pth(tmp / "seg_weights.pth", "sup_unsup_seg")
    base, seg = _test_argv(split, pth), _test_argv(split, seg_pth, True)
    with ThreadPoolExecutor(3) as pool:
        yield seg_pth, {
            "test": pool.submit(jax_cli.main, base + [
                "--report-json", str(tmp / "jax.json")]),
            "seg_test": pool.submit(jax_cli.main, seg + [
                "--report-json", str(tmp / "jseg.json")]),
            "seg_engine": pool.submit(_jax_engine, seg_pth, split),
        }


def _common(split, pth, seg=False):
    """The flags of both CLIs' ``test`` and ``serve`` at the tiny widths."""
    preset = ["--preset", "sup_unsup_seg"] if seg else []
    return ["--split", str(split), "--checkpoint", str(pth)] + preset + (
        TINY_FLAGS)


def _test_argv(split, pth, seg=False):
    return ["test", "--test-batch", "4"] + _common(split, pth, seg)


@pytest.fixture(scope="module")
def reports(corpus, jax_runs):
    tmp, split, pth = corpus
    assert cli.main(_test_argv(split, pth) + [
        "--report-json", str(tmp / "port.json"), "--device", "cpu"]) == 0
    assert jax_runs[1]["test"].result() == 0
    return (json.loads((tmp / "jax.json").read_text()),
            json.loads((tmp / "port.json").read_text()))


def test_cli_test_report_matches_jax(reports):
    want, got = reports
    assert got.keys() == want.keys()
    assert TIMING_KEYS == JAX_TIMING_KEYS
    compared = [k for k in want if k not in TIMING_KEYS]
    assert len(compared) == 18 and got["frames"] == 6.0
    for k in compared:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)
    # the predictions spread: the metrics are not those of a constant map
    assert 5.0 < got["mae_100"] < 45.0


def test_cli_test_rain_split_matches_jax(reports):
    want, got = reports
    # frame 3 of 6 is the one rain frame: its RMSE is the edge split
    for k in ("rmse_edge", "rmse_sunny"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4)
    assert got["rmse_edge"] != got["rmse_sunny"]
    assert min(got["rmse_edge"], got["rmse_sunny"]) <= got["rmse_100"] <= (
        max(got["rmse_edge"], got["rmse_sunny"]))


def test_cli_serve_writes_one_depth_map_per_frame(corpus, tmp_path,
                                                  capsys):
    _, split, pth = corpus
    out = tmp_path / "served"
    assert cli.main(["serve", "--split", str(split),
                     "--checkpoint", str(pth), "--serve-batch", "4",
                     "--out", str(out), "--device", "cpu"] + TINY_FLAGS) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["frames"] == 6 and stats["frames_processed"] == 6.0
    maps = sorted(out.glob("*_depth.npy"))
    assert [p.name for p in maps] == [f"{i:05d}_depth.npy" for i in range(6)]
    for p in maps:
        d = np.load(p)
        assert d.shape == HW and np.isfinite(d).all()
        assert 0.0 <= d.min() and d.max() <= 100.0


@pytest.fixture(scope="module")
def seg_runs(corpus, jax_runs):
    """``cli test`` of the JAX package and of the port on the 6-frame
    corpus at --preset sup_unsup_seg, tiny widths, fp32; the port's ``cli
    serve`` of the same, and the JAX engine's forward on those frames."""
    tmp, split, _ = corpus
    pth, jobs = jax_runs
    assert cli.main(_test_argv(split, pth, seg=True) + [
        "--report-json", str(tmp / "seg.json"), "--device", "cpu"]) == 0
    assert cli.main(["serve", "--serve-batch", "4", "--out",
                     str(tmp / "served"), "--device", "cpu"]
                    + _common(split, pth, seg=True)) == 0
    assert jobs["seg_test"].result() == 0
    return (json.loads((tmp / "jseg.json").read_text()),
            json.loads((tmp / "seg.json").read_text()),
            jobs["seg_engine"].result(), tmp / "served")


def test_cli_test_seg_report_matches_jax(seg_runs, capsys):
    want, got, _, _ = seg_runs
    assert got.keys() == want.keys() and "iou" in got
    compared = [k for k in want if k not in TIMING_KEYS]
    assert len(compared) == 19 and got["frames"] == 6.0
    for k in compared:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)
    assert 0.0 < got["iou"] < 1.0


def test_cli_serve_writes_seg_labels_of_the_jax_engine(seg_runs):
    """One uint8 label map per frame beside its depth map, agreeing with
    the JAX engine's labels; depth within 1e-3 at >= 99 % of the pixels
    (a flipped near-tie guidance pixel moves the depth near it,
    tests/test_torch_model.py)."""
    _, _, engine, port_dir = seg_runs
    names = sorted(p.name for p in port_dir.glob("*_seg.npy"))
    assert names == [f"{i:05d}_seg.npy" for i in range(6)]
    got = np.stack([np.load(port_dir / n) for n in names])
    assert got.dtype == engine["seg"].dtype == np.uint8
    assert got.shape == (6,) + HW and got.max() < 21
    agree = float(np.mean(got == engine["seg"]))
    assert agree >= 0.995, agree
    depth = np.stack([np.load(port_dir / f"{i:05d}_depth.npy")
                      for i in range(6)])
    err = np.abs(depth - engine["depth"])
    assert (err <= 1e-3 + 1e-3 * np.abs(engine["depth"])).mean() >= 0.99
