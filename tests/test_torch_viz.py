"""The port's visualization (camradepth_tpu_torch.viz, ``cli viz``)
against the JAX package's (camradepth_tpu.viz), on the CPU.

- The panel and collage functions are numpy and cv2 in both packages: bit
  for bit on the same seeded arrays, and ``run_visualization`` with one
  ``predict`` writes the same collages bit for bit.
- On a serving artifact ``cli viz`` maps the decoded depth back to
  1 - d / max_depth (the artifact's program is stubbed by the tiny model's
  forward, decoded as an artifact decodes it) and writes the ``.pth``'s
  collages (at most 0.1 % of pixels differing); an artifact of another
  geometry is refused with the JAX package's message.

``cli viz`` on a ``.pth`` against ``camradepth_tpu.cli viz`` is in
tests/test_torch_roofline.py, beside the other JAX references that run in
an interpreter of their own.
"""

import json
import struct

import cv2
import numpy as np
import pytest
import torch

from camradepth_tpu import viz as jviz
from camradepth_tpu.config import DataConfig as JDataConfig
from camradepth_tpu.data.pipeline import make_loaders as jloaders
from camradepth_tpu_torch import cli, viz
from camradepth_tpu_torch.config import DataConfig, tiny_test_config
from camradepth_tpu_torch.data.pipeline import make_loaders
from camradepth_tpu_torch.interop import export as X
from tests import torch_tools as T
from tests.torch_port import one_torch_thread  # noqa: F401

HW = T.HW


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    corpus = T.viz_corpus(tmp_path_factory.mktemp("viz"))
    T.port_viz(corpus, corpus["tmp"] / "port")
    return corpus


def test_viz_functions_bit_for_bit():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((32, 64, 7)).astype(np.float32)
    feats[..., 3] = np.where(rng.random((32, 64)) < 0.05,
                             rng.random((32, 64)), 0).astype(np.float32)
    gt = np.where(rng.random((32, 64)) < 0.1, rng.random((32, 64)),
                  0).astype(np.float32)
    depth = rng.uniform(-0.1, 1.1, (32, 64)).astype(np.float32)
    seg = rng.integers(0, 30, (32, 64))
    seg[::5] = 255

    def same(a, b):
        assert a.dtype == b.dtype and np.array_equal(a, b)

    same(viz.denormalize_image(feats), jviz.denormalize_image(feats))
    for black in (True, False):
        same(viz.colorize_depth(depth, invalid_black=black),
             jviz.colorize_depth(depth, invalid_black=black))
    same(viz.colorize_seg(seg), jviz.colorize_seg(seg))
    img = viz.denormalize_image(feats)
    for radius in (1, 2, 3):
        same(viz.overlay_sparse(img, gt, radius),
             jviz.overlay_sparse(img, gt, radius))
    for pred_seg, seg_gt in ((seg, None), (None, seg), (None, None)):
        pred = {"depth": depth, "seg": pred_seg}
        got = viz.frame_panels(feats, gt, pred, seg_gt=seg_gt)
        want = jviz.frame_panels(feats, gt, pred, seg_gt=seg_gt)
        assert list(got) == list(want)
        for k in got:
            same(got[k], want[k])
        for cols in (2, 3):
            same(viz.collage(got, cols), jviz.collage(want, cols))
    # a panel of another size is resized into its cell
    panels = {"a": img, "b": cv2.resize(img, (32, 16))}
    same(viz.collage(panels), jviz.collage(panels))


def test_run_visualization_with_predict_matches_jax(corpus, tmp_path):
    kw = dict(image_dimension=HW, split_path=corpus["split"],
              mini_dataset=True)
    rng = np.random.default_rng(1)

    def predict(feats):
        b = feats.shape[0]
        return (rng.uniform(0, 1, (b, *HW)).astype(np.float32),
                rng.integers(0, 21, (b, *HW)))

    cfg = tiny_test_config()
    state = rng.bit_generator.state
    n = viz.run_visualization(cfg, None, make_loaders(
        DataConfig(**kw), batch_size=4)["test"], tmp_path / "port", 5,
        predict=predict, device="cpu")
    rng.bit_generator.state = state
    m = jviz.run_visualization(cfg, None, None, jloaders(
        JDataConfig(**kw), batch_size=4)["test"], tmp_path / "jax", 5,
        predict=predict)
    assert n == m == 5
    got, want = T.pngs(tmp_path / "port"), T.pngs(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 5
    for k in got:
        assert np.array_equal(got[k], want[k]), k


def _fake_artifact(path, img_size, max_depth=100.0):
    header = {"format": X.FORMAT, "img_size": list(img_size),
              "input_channels": 7, "batch_size": 4, "max_depth": max_depth,
              "decode_depth": True, "blob_sha256": ""}
    hdr = json.dumps(header).encode()
    path.write_bytes(X.MAGIC + struct.pack("<Q", len(hdr)) + hdr)
    return header


def test_cli_viz_artifact_decodes_and_refuses_geometry(corpus, monkeypatch,
                                                       capsys):
    model, tmp = corpus["model"], corpus["tmp"]
    art = tmp / "a.pt2"
    header = _fake_artifact(art, HW)

    def call(x):
        with torch.inference_mode():
            enc = model(x)["depth"]["final_depth"][..., 0].clamp(0, 1)
        return {"depth": (1.0 - enc) * header["max_depth"], "seg": None}

    monkeypatch.setattr(cli, "_load_artifact",
                        lambda cfg, path, dev: (call, header))
    args = [a if a != str(corpus["weights"]) else str(art)
            for a in corpus["args"]]
    assert cli.main([*args, "--out", str(tmp / "art"), "--device",
                     "cpu"]) == 0
    diff, total = T.differing(T.pngs(tmp / "art"), T.pngs(tmp / "port"))
    print(f"cli viz on an artifact: {diff} of {total} pixels differ from "
          "the .pth's")
    assert diff <= T.PIXEL_SHARE * total

    _fake_artifact(art, (32, 64))
    capsys.readouterr()
    assert cli.main([*args, "--out", str(tmp / "no"), "--device",
                     "cpu"]) == 2
    err = capsys.readouterr().err
    assert ("artifact geometry [32, 64] does not match the 'base' config's "
            "[64, 128] — pass the preset it was exported from") in err
