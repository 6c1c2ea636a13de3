"""The port's compact wire format (camradepth_tpu_torch.data.wire) against
the JAX package's (camradepth_tpu.data.wire), on the CPU.

- The host side: ``plan_wire`` and ``encode_frame_wire`` give the JAX
  package's plans and examples array for array on a synthetic corpus at
  64x128, for the standard radar stack with sparse GT, the filtered radar,
  and GT shipped dense (the probe picks gt_cap 0 at this size); an
  overflow raises in both.
- The decode: ``decode_wire_micro`` is bit for bit with JAX's on the same
  wire batch, with ``radar_val`` in fp32 and rounded to bf16 (both round
  to nearest even), and the decoded loader batch is bit for bit the port's
  dense batch, but for the one canonicalization of the codec (a -0.0 of a
  source raster that is no point decodes as +0.0, as in JAX).
- The refusals: ``wire_format=on`` where the codec does not cover the
  config, and an explicit ``wire_ship_seg=False`` that a seg config reads
  (one line from the CLI).
- The slice as a whole: ``cli test --wire on`` gives the dense report and
  ``cli serve --wire on`` the dense depth maps, exactly.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camradepth_tpu.config import DataConfig as JaxDataConfig
from camradepth_tpu.config import tiny_test_config as jax_tiny_config
from camradepth_tpu.data import pipeline as jax_pipeline
from camradepth_tpu.data import wire as jax_wire
from camradepth_tpu_torch import cli
from camradepth_tpu_torch.config import (
    ConfigError,
    DataConfig,
    tiny_test_config,
)
from camradepth_tpu_torch.data import pipeline, synthetic, wire
from camradepth_tpu_torch.models.camradepth import create_model
from camradepth_tpu_torch.serving import DepthEngine
from tests.torch_port import one_torch_thread  # noqa: F401

HW = (64, 128)
TINY_FLAGS = [
    "--set", "model.img_size=64,128", "--set", "model.dims=16,32,32,64",
    "--set", "model.ff_expansion=2,2,2,2", "--set", "model.depths=1,1,1,1",
    "--set", "model.mid_channels=32", "--set", "data.image_dimension=64,128",
    "--set", "model.compute_dtype=float32", "--set", "data.mini_dataset=1",
]
# the data configs of the codec: sparse GT needs a cap set here (the probe
# ships 25 %-dense GT dense at 64x128), dense GT is what the probe picks
CONFIGS = {
    "sparse_gt": dict(wire_gt_cap=3072),
    "filtered_radar": dict(filtered_radar=True, wire_gt_cap=3072),
    "dense_gt": {},
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 6-frame corpus and a reference .pth of the tiny base model."""
    tmp = tmp_path_factory.mktemp("wire")
    split = synthetic.generate(tmp / "data", num_frames=6, hw=HW, seed=3)
    pth = tmp / "weights.pth"
    torch.save({"state_dict": create_model(tiny_test_config().model,
                                           device="cpu").state_dict()}, pth)
    return tmp, split, pth


def _rows(split):
    return np.load(split, allow_pickle=True)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_and_encode_match_jax(corpus, name):
    _, split, _ = corpus
    ours = DataConfig(image_dimension=HW, **CONFIGS[name])
    theirs = JaxDataConfig(image_dimension=HW, **CONFIGS[name])
    rows = _rows(split)
    plan = wire.plan_wire(rows, ours)
    want = jax_wire.plan_wire(rows, theirs)
    assert dataclasses.asdict(plan) == dataclasses.asdict(want)
    assert (plan.gt_cap == 0) == (name == "dense_gt")
    for row in rows:
        got = wire.encode_frame_wire(
            pipeline.load_frame_arrays(row, ours), ours, plan)
        exp = jax_wire.encode_frame_wire(
            jax_pipeline.load_frame_arrays(row, theirs), theirs, want)
        assert sorted(got) == sorted(exp)
        for k in exp:
            assert got[k].dtype == exp[k].dtype, k
            np.testing.assert_array_equal(got[k], exp[k], err_msg=k)
    small = dataclasses.replace(plan, radar_cap=4)
    arrays = pipeline.load_frame_arrays(rows[0], ours)
    with pytest.raises(wire.WireOverflowError, match="wire_radar_cap"):
        wire.encode_frame_wire(arrays, ours, small)
    with pytest.raises(jax_wire.WireOverflowError):
        jax_wire.encode_frame_wire(
            jax_pipeline.load_frame_arrays(rows[0], theirs), theirs,
            dataclasses.replace(want, radar_cap=4))


def _wire_batch(split, cfg):
    """One 6-frame wire batch and the dense batch of the same frames."""
    kw = dict(batch_size=6, split_path=split)
    dense = next(iter(pipeline.make_loaders(cfg, **kw)["test"]))
    packed = next(iter(pipeline.make_loaders(cfg, wire_eval=True,
                                             **kw)["test"]))
    return packed, dense


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax_bit_for_bit(corpus, dtype):
    _, split, _ = corpus
    cfg = DataConfig(image_dimension=HW, mini_dataset=True, wire_gt_cap=3072)
    packed, _ = _wire_batch(split, cfg)
    keys = wire.WIRE_KEYS + ("seg", "seg_inter")
    ours = {k: torch.from_numpy(packed[k]) for k in keys}
    theirs = {k: jnp.asarray(packed[k]) for k in keys}
    if dtype == "bfloat16":
        ours["radar_val"] = ours["radar_val"].to(torch.bfloat16)
        theirs["radar_val"] = theirs["radar_val"].astype(jnp.bfloat16)
        np.testing.assert_array_equal(
            ours["radar_val"].view(torch.int16).numpy(),
            np.asarray(theirs["radar_val"]).view(np.int16))
    got = wire.decode_wire_micro(ours)
    want = jax.jit(jax_wire.decode_wire_micro)(theirs)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                      err_msg=k)


@pytest.mark.parametrize("name", ["sparse_gt", "dense_gt"])
def test_decoded_batch_is_the_dense_batch(corpus, name):
    """Bit for bit after the codec's one canonicalization (-0.0 -> +0.0,
    which the synthetic radar's uv planes hold where there is no point)."""
    _, split, _ = corpus
    cfg = DataConfig(image_dimension=HW, mini_dataset=True, **CONFIGS[name])
    packed, dense = _wire_batch(split, cfg)
    assert ("gt_val" in packed) == (name == "sparse_gt")
    got = wire.decode_wire_micro({k: torch.from_numpy(v)
                                  for k, v in packed.items()})
    neg_zero = (dense["features"] == 0) & np.signbit(dense["features"])
    assert neg_zero.any()
    for k in ("features", "gt_depth", "seg", "seg_inter"):
        g, w = got[k].numpy(), dense[k]
        if w.dtype == np.float32:
            w = w + np.float32(0.0)  # -0.0 -> +0.0
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                      err_msg=k)
    np.testing.assert_array_equal(got["valid"].numpy(), dense["valid"])
    np.testing.assert_array_equal(got["index"].numpy(), dense["index"])


def _seg_cfg(cfg, sup, inter, **data_kw):
    return cfg.replace(
        model=dataclasses.replace(cfg.model, supervised_seg=sup),
        train=dataclasses.replace(cfg.train, seg_inter_loss=inter),
        data=dataclasses.replace(cfg.data, **data_kw))


def test_resolve_wire_ship_matches_jax_and_refuses_a_dropped_plane():
    for sup, inter in ((False, False), (True, False), (True, True)):
        got = wire.resolve_wire_ship(_seg_cfg(tiny_test_config(), sup, inter))
        want = jax_wire.resolve_wire_ship(
            _seg_cfg(jax_tiny_config(), sup, inter))
        assert (got.wire_ship_seg, got.wire_ship_seg_inter) == (
            want.wire_ship_seg, want.wire_ship_seg_inter) == (sup, inter)
    for field, inter in (("wire_ship_seg", False),
                         ("wire_ship_seg_inter", True)):
        with pytest.raises(ConfigError, match=f"{field}=False"):
            wire.resolve_wire_ship(_seg_cfg(tiny_test_config(), True, inter,
                                            **{field: False}))


def test_wire_on_refuses_a_config_the_codec_does_not_cover(corpus, capsys):
    _, split, pth = corpus
    cfg = DataConfig(image_dimension=HW, train_val_split=(4, 1), im_uv=True,
                     wire_format="on")
    with pytest.raises(ConfigError, match="wire_format=on"):
        pipeline.make_loaders(cfg, 2, split_path=split, wire=True)
    # auto falls back to dense batches
    auto = dataclasses.replace(cfg, wire_format="auto")
    loaders = pipeline.make_loaders(auto, 2, split_path=split, wire=True)
    assert loaders["train"].frames.wire_plan is None
    with pytest.raises(ConfigError, match="off|auto|on"):
        DataConfig(wire_format="yes")
    # the CLI reports the refusals in one line
    for extra in (["--set", "data.im_uv=1"],
                  ["--preset", "supervised_seg", "--set",
                   "data.wire_ship_seg=0"]):
        rc = cli.main(["test", "--split", str(split), "--checkpoint",
                       str(pth), "--device", "cpu", "--wire", "on"]
                      + TINY_FLAGS + extra)
        err = capsys.readouterr().err.strip()
        assert rc == 2 and err.startswith("error:") and "\n" not in err, err


def test_engine_refuses_a_plan_of_other_channels():
    cfg = tiny_test_config()
    model = create_model(cfg.model, device="cpu")
    plan = wire.WirePlan(radar_cap=256, gt_cap=0, n_radar_ch=1)
    with pytest.raises(ValueError, match="3\\+1 channels"):
        DepthEngine(cfg, model, batch_size=2, device="cpu", wire_plan=plan)


def test_cli_test_and_serve_wire_give_the_dense_results(corpus, tmp_path,
                                                        capsys):
    _, split, pth = corpus
    common = ["--split", str(split), "--checkpoint", str(pth), "--device",
              "cpu"] + TINY_FLAGS
    reports, maps = {}, {}
    for mode in ("off", "on"):
        path = tmp_path / f"{mode}.json"
        assert cli.main(["test", "--test-batch", "4", "--wire", mode,
                         "--report-json", str(path)] + common) == 0
        reports[mode] = json.loads(path.read_text())
        out = tmp_path / f"served_{mode}"
        assert cli.main(["serve", "--serve-batch", "4", "--wire", mode,
                         "--out", str(out)] + common) == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stats["frames"] == 6
        maps[mode] = np.stack([np.load(out / f"{i:05d}_depth.npy")
                               for i in range(6)])
    from camradepth_tpu_torch.evaluation.harness import TIMING_KEYS

    assert reports["on"].keys() == reports["off"].keys()
    for k, v in reports["off"].items():
        if k not in TIMING_KEYS:
            assert reports["on"][k] == v, k
    assert reports["on"]["frames"] == 6.0
    np.testing.assert_array_equal(maps["on"], maps["off"])
