"""The port's data pipeline, metrics, evaluation harness and CLI
(camradepth_tpu_torch.{data,evaluation,cli}) against the JAX package's, on
the CPU.

- Metrics: the same random pred/gt through both, NaN in the same places
  (empty bands), rtol 1e-5 (fp32 sums in other orders).
- Data: frames and loader batches of a ``synthetic.generate`` corpus at
  64x128 agree bit for bit (both packages assemble with their C++ host
  code by default, each bit for bit with its numpy path,
  tests/test_torch_native.py).
- The slice as a whole: ``camradepth_tpu.cli test`` and the port's ``cli
  test --device cpu`` on one 6-frame corpus and one reference .pth at the
  ``tiny_test_config`` widths in fp32; every non-timing report key agrees
  to rtol 1e-3, atol 1e-4 (the two forwards agree to ~1e-5 in fp32,
  tests/test_torch_model.py; metrics are means over a few thousand pixels),
  and the same for ``--preset sup_unsup_seg``, the ``iou`` key included;
  its ``cli serve`` labels against the JAX engine's by agreement >= 0.995
  (argmax maps: near-tie pixels may flip between frameworks,
  tests/test_flagship_golden.py:131-140). The three JAX runs start
  together on threads (``jax_runs``), beside the port's.
"""

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camradepth_tpu import cli as jax_cli
from camradepth_tpu.config import DataConfig as JaxDataConfig
from camradepth_tpu.data import channels as jax_channels
from camradepth_tpu.data import pipeline as jax_pipeline
from camradepth_tpu.evaluation import metrics as JM
from camradepth_tpu.evaluation.harness import TIMING_KEYS as JAX_TIMING_KEYS
from camradepth_tpu_torch import cli
from camradepth_tpu_torch.config import DataConfig, tiny_test_config
from camradepth_tpu_torch.config import preset as preset_config
from camradepth_tpu_torch.data import channels, pipeline, synthetic
from camradepth_tpu_torch.evaluation import metrics as M
from camradepth_tpu_torch.evaluation.harness import TIMING_KEYS
from camradepth_tpu_torch.interop.golden import synth_state_values
from camradepth_tpu_torch.models.camradepth import create_model
from tests.torch_port import one_torch_thread  # noqa: F401

HW = (64, 128)
# tiny_test_config's model widths, as CLI overrides both CLIs take
TINY_FLAGS = [
    "--set", "model.img_size=64,128", "--set", "model.dims=16,32,32,64",
    "--set", "model.ff_expansion=2,2,2,2", "--set", "model.depths=1,1,1,1",
    "--set", "model.mid_channels=32", "--set", "model.drop_path_rate=0",
    "--set", "data.image_dimension=64,128",
    "--set", "model.compute_dtype=float32", "--set", "data.mini_dataset=1",
]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 6-frame corpus (frame 3 is a rain frame) and a reference .pth of
    synthesized weights whose depth head is biased to the middle of [0, 1],
    so the predictions spread over the metric range."""
    tmp = tmp_path_factory.mktemp("corpus")
    split = synthetic.generate(tmp / "data", num_frames=6, hw=HW, seed=0)
    return tmp, split, _tiny_pth(tmp / "weights.pth")


def _tiny_pth(path, preset="base", **kw):
    """A reference .pth of synthesized weights for the tiny widths of
    ``preset``, the final depth head biased to the middle of [0, 1]."""
    cfg = tiny_test_config().model
    flags = {k: getattr(preset_config(preset).model, k)
             for k in ("supervised_seg", "unsupervised_seg")}
    model = create_model(dataclasses.replace(cfg, **flags, **kw),
                         device="cpu")
    sd = synth_state_values({k: tuple(v.shape)
                             for k, v in model.state_dict().items()})
    sd["depth_activation_5.conv_2.bias"] = sd[
        "depth_activation_5.conv_2.bias"] + np.float32(0.5)
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in sd.items()}}, path)
    return path


def _metric_inputs(seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(-0.1, 1.1, (4, 12, 16)).astype(np.float32)
    gt = rng.uniform(0.0, 1.0, (4, 12, 16)).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < 0.5] = 0.0  # invalid pixels
    gt[1] = 0.0                                   # a frame with no GT
    gt[2] = np.minimum(gt[2], 0.45)               # empty 50 m band
    return pred, gt


def test_depth_metrics_match_jax():
    pred, gt = _metric_inputs()
    want = JM.depth_metrics_inverse(jnp.asarray(pred), jnp.asarray(gt))
    want.update(JM.depth_metrics_true(jnp.asarray(pred), jnp.asarray(gt)))
    got = M.depth_metrics_inverse(torch.from_numpy(pred),
                                  torch.from_numpy(gt))
    got.update(M.depth_metrics_true(torch.from_numpy(pred),
                                    torch.from_numpy(gt)))
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == (4,) and g.dtype == np.float32, k
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=k)
    assert np.isnan(got["mae_100"][1].item())
    assert np.isnan(got["rmse_50"][2].item())


def test_jaccard_index_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 8, 8, 5)).astype(np.float32)
    target = rng.integers(0, 5, (3, 8, 8)).astype(np.int32)
    target[1] = 255  # all ignored: NaN
    target[2, :4] = 255
    want = np.asarray(JM.jaccard_index(jnp.asarray(logits),
                                       jnp.asarray(target), 5))
    got = M.jaccard_index(torch.from_numpy(logits),
                          torch.from_numpy(target), 5).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.isnan(got[1])


def test_synthetic_corpus_matches_jax(tmp_path):
    from camradepth_tpu.data import synthetic as jax_synthetic

    ours = np.load(synthetic.generate(tmp_path / "t", 3, HW, seed=5))
    theirs = np.load(jax_synthetic.generate(tmp_path / "j", 3, HW, seed=5))
    for a, b in zip(ours.ravel(), theirs.ravel()):
        assert Path(a).name == Path(b).name
        assert Path(a).read_bytes() == Path(b).read_bytes(), a


def test_inverse_depth_codec_matches_jax():
    depth = np.random.default_rng(3).uniform(-5, 130, (6, 9)).astype(
        np.float32)
    depth[0] = 0.0
    enc = channels.encode_inverse_depth(depth)
    np.testing.assert_array_equal(enc,
                                  jax_channels.encode_inverse_depth(depth))
    np.testing.assert_array_equal(channels.decode_inverse_depth(enc),
                                  jax_channels.decode_inverse_depth(enc))
    assert (enc[0] == 0).all() and enc.dtype == np.float32


def test_assemble_frame_matches_jax(corpus):
    _, split, _ = corpus
    rows = np.load(split)
    cfg = DataConfig(image_dimension=HW)
    jcfg = JaxDataConfig(image_dimension=HW)
    for row in rows:
        got = channels.assemble_frame(pipeline.load_frame_arrays(row, cfg),
                                      cfg)
        want = jax_channels.assemble_frame(
            jax_pipeline.load_frame_arrays(row, jcfg), jcfg)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["features"].shape == HW + (7,)


def test_loader_batches_match_jax(corpus):
    _, split, _ = corpus
    cfg = DataConfig(image_dimension=HW, mini_dataset=True, num_workers=2)
    jcfg = JaxDataConfig(image_dimension=HW, mini_dataset=True,
                         num_workers=2)
    ours = pipeline.make_loaders(cfg, batch_size=4, split_path=split)
    theirs = jax_pipeline.make_loaders(jcfg, batch_size=4, split_path=split)
    assert ours["train"] is ours["val"] is None
    got, want = list(ours["test"]), list(theirs["test"])
    assert len(got) == len(want) == 2  # 4 frames, then 2 padded to 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    np.testing.assert_array_equal(got[1]["valid"], [1, 1, 0, 0])
    assert [ours["test"].frames.name(i) for i in range(6)] == [
        theirs["test"].frames.name(i) for i in range(6)]


def test_loader_refuses_the_wire_format(corpus):
    """The wire format is ported (tests/test_torch_wire.py); with
    wire_format=on the loader still refuses it where the codec does not
    cover the channel config (im_uv, a dense flow image)."""
    from camradepth_tpu_torch.config import ConfigError

    _, split, _ = corpus
    cfg = DataConfig(image_dimension=HW, mini_dataset=True, im_uv=True,
                     wire_format="on")
    with pytest.raises(ConfigError, match="wire_format=on"):
        pipeline.make_loaders(cfg, batch_size=2, split_path=split,
                              wire_eval=True)


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


def test_cli_tpu_decoder_refuses_a_reference_checkpoint(corpus, capsys):
    _, split, pth = corpus
    for command in ("test", "serve"):
        rc = cli.main([command, "--tpu-decoder", "--split", str(split),
                       "--checkpoint", str(pth), "--device", "cpu"]
                      + TINY_FLAGS)
        err = capsys.readouterr().err.strip()
        assert rc == 2 and "tpu_decoder variant" in err, err
        assert err.startswith("error:") and "\n" not in err


# serving on a mesh needs a rank per share (cli serve on one process has
# one), and a mesh.* layout is training's: each refused in one line
@pytest.mark.parametrize("extra,item", [
    (["--http-port", "0", "--data-parallel", "2"], "needs 2 ranks, have 1"),
    (["--set", "mesh.spatial_parallel=2"], "--spatial-parallel"),
    (["--data-parallel", "2"], "needs 2 ranks, have 1"),
    (["--spatial-parallel", "2"], "needs 2 ranks, have 1"),
    (["--set", "mesh.data_parallel=2"], "mesh.* layout"),
])
def test_cli_refuses_options_of_later_slices(corpus, capsys, extra, item):
    _, split, pth = corpus
    rc = cli.main(["serve", "--split", str(split),
                   "--checkpoint", str(pth), "--device", "cpu"]
                  + TINY_FLAGS + extra)
    assert rc == 2
    assert item in capsys.readouterr().err


def test_cli_refuses_artifact_checkpoints(capsys, tmp_path):
    """A StableHLO artifact of the JAX package is refused in one line (the
    port serves its own artifacts, tests/test_torch_export.py), and so is
    a missing one."""
    jax_artifact = tmp_path / "model.hlo"
    jax_artifact.write_bytes(b"CRDSHLO1" + bytes(8))
    for path, match in ((jax_artifact, "JAX StableHLO artifact"),
                        (tmp_path / "missing.hlo", "No such file")):
        assert cli.main(["test", "--checkpoint", str(path),
                         "--device", "cpu"]) == 2
        err = capsys.readouterr().err.strip()
        assert match in err and "\n" not in err, err


def test_cli_defaults_to_the_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, split, pth = corpus
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["test", "--split", str(split),
                  "--checkpoint", str(pth)] + TINY_FLAGS)
