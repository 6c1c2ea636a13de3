"""The port's data pipeline and metrics (camradepth_tpu_torch.{data,
evaluation}) against the JAX package's, on the CPU.

- Metrics: the same random pred/gt through both, NaN in the same places
  (empty bands), rtol 1e-5 (fp32 sums in other orders).
- Data: frames and loader batches of a ``synthetic.generate`` corpus at
  64x128 agree bit for bit (both packages assemble with their C++ host
  code by default, each bit for bit with its numpy path,
  tests/test_torch_native.py).

The slice as a whole, ``cli test`` and ``cli serve`` against the JAX
package's, is in tests/test_torch_eval_cli.py; the CLI's refusals in
tests/test_torch_eval_refusals.py.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camradepth_tpu.config import DataConfig as JaxDataConfig
from camradepth_tpu.data import channels as jax_channels
from camradepth_tpu.data import pipeline as jax_pipeline
from camradepth_tpu.evaluation import metrics as JM
from camradepth_tpu_torch.config import DataConfig, tiny_test_config
from camradepth_tpu_torch.config import preset as preset_config
from camradepth_tpu_torch.data import channels, pipeline, synthetic
from camradepth_tpu_torch.evaluation import metrics as M
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
