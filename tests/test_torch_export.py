"""The port's serving artifact (camradepth_tpu_torch.interop.export) and
its consumers, on the CPU, at the ``tiny_test_config`` widths in fp32.

- The exported graph holds the kernels as operators of their own (4
  attention scores and 5 bicubic at these widths, no GELU in fp32; a bf16
  decoder stage's bicubic and GELUs), so on a card the artifact launches
  the Hopper kernels; here each runs its plain version.
- A dynamic-batch artifact, written by ``cli export``, serves batches 1
  and 3 and equals the live engine (rtol 1e-6: the same operations in the
  same order); ``cli test`` on it equals ``cli test`` on the ``.pth``
  (rtol 1e-6 per non-timing key: the depth is decoded and encoded back
  once more), and ``cli serve`` on it writes the ``.pth``'s depth maps.
- The header has the keys of ``camradepth_tpu/interop/hlo_export.py``'s;
  a corrupt blob, a bad magic, another geometry and a JAX StableHLO file
  are refused in one line.

The artifact is exported once and its program loaded once per module (a
round trip takes ~20 s at these widths, most of it torch.export's
tracing and deserialization); the CLI runs reuse the loaded program.
"""

import ast
import collections
import dataclasses
import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import camradepth_tpu
from camradepth_tpu_torch import cli
from camradepth_tpu_torch.config import ExperimentConfig, tiny_test_config
from camradepth_tpu_torch.data import synthetic
from camradepth_tpu_torch.evaluation.harness import TIMING_KEYS
from camradepth_tpu_torch.interop import export as X
from camradepth_tpu_torch.models.camradepth import create_model
from camradepth_tpu_torch.models.layers import Decoder
from camradepth_tpu_torch.serving import DepthEngine
from tests.torch_port import one_torch_thread  # noqa: F401

HW = (64, 128)
# tiny_test_config's model widths, as CLI overrides
TINY_FLAGS = [
    "--set", "model.img_size=64,128", "--set", "model.dims=16,32,32,64",
    "--set", "model.ff_expansion=2,2,2,2", "--set", "model.depths=1,1,1,1",
    "--set", "model.mid_channels=32", "--set", "model.drop_path_rate=0",
    "--set", "data.image_dimension=64,128",
    "--set", "model.compute_dtype=float32", "--set", "data.mini_dataset=1",
]
OPS = {"scores": "camradepth.maxpool_attention_scores.default",
       "bicubic": "camradepth.upsample_bicubic_x2.default",
       "gelu": "camradepth.gelu_bf16.default"}


def _tiny_cfg(**model_kw):
    cfg = tiny_test_config()
    return cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))


def _op_counts(graph) -> dict:
    c = collections.Counter(str(n.target) for n in graph.nodes
                            if n.op == "call_function")
    return {k: c[v] for k, v in OPS.items()}


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """A 6-frame corpus, a .pth of seeded weights, the dynamic-batch
    artifact ``cli export`` writes from it, and that artifact loaded."""
    tmp = tmp_path_factory.mktemp("export")
    split = synthetic.generate(tmp / "data", num_frames=6, hw=HW, seed=0)
    cfg = _tiny_cfg()
    model = create_model(cfg.model, device="cpu", seed=3)
    pth = tmp / "w.pth"
    torch.save({"state_dict": model.state_dict()}, pth)
    path = tmp / "a.pt2"
    assert cli.main(["export", "--checkpoint", str(pth), "--out", str(path),
                     "--format", "artifact", "--dynamic-batch",
                     "--device", "cpu", *TINY_FLAGS]) == 0
    loaded = X.load_serving_artifact(str(path), "cpu")
    return dict(tmp=tmp, split=split, cfg=cfg, model=model, pth=pth,
                path=path, loaded=loaded)


@pytest.fixture
def loaded_once(art, monkeypatch):
    """``load_serving_artifact`` answers the module's artifact with the
    program the fixture loaded."""
    real = X.load_serving_artifact

    def load(path, device="cuda"):
        if Path(path) == art["path"] and str(device) == "cpu":
            return art["loaded"]
        return real(path, device)

    monkeypatch.setattr(X, "load_serving_artifact", load)


def test_graph_holds_the_kernel_ops(art):
    call, header = art["loaded"]
    assert _op_counts(call.module.graph) == {"scores": 4, "bicubic": 5,
                                             "gelu": 0}
    assert header["batch_size"] is None and header["platforms"] == [
        "cpu", "cuda"]


def test_bf16_graph_holds_a_gelu_op_per_gelu():
    """In bf16 the GELU is an operator of the graph too: a bf16 decoder
    stage (a bicubic x2, then three ConvLayers, each ending in a GELU),
    exported as the serving forward is, holds one bicubic and three GELU
    operators, and its program computes the stage's bits."""
    stage = Decoder(16, 16, mid_channels=16).to(torch.bfloat16).eval()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 4, 8, 16), dtype=np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        ep = torch.export.export(stage.requires_grad_(False), (x,))
        want = stage(x)
    assert _op_counts(ep.graph) == {"scores": 0, "bicubic": 1, "gelu": 3}
    assert torch.equal(ep.module()(x), want)


@pytest.mark.parametrize("n", [1, 3])
def test_dynamic_batch_artifact_matches_live_engine(art, n):
    call, _ = art["loaded"]
    live = DepthEngine(art["cfg"], art["model"], batch_size=4, device="cpu")
    x = np.random.default_rng(n).standard_normal(
        (n, *HW, 7)).astype(np.float32)
    got = call(torch.from_numpy(x))
    assert got["seg"] is None and got["depth"].shape == (n, *HW)
    np.testing.assert_allclose(got["depth"].numpy(),
                               live.infer_batch(x)["depth"], rtol=1e-6,
                               atol=0)


def test_cli_test_on_the_artifact_equals_the_pth(art, loaded_once):
    reports = []
    for ckpt in (art["path"], art["pth"]):
        out = art["tmp"] / f"report_{Path(ckpt).suffix[1:]}.json"
        assert cli.main(["test", "--split", str(art["split"]),
                         "--checkpoint", str(ckpt), "--report-json",
                         str(out), "--device", "cpu", *TINY_FLAGS]) == 0
        reports.append(json.loads(out.read_text()))
    got, want = reports
    assert got.keys() == want.keys()
    for k in want:
        if k not in TIMING_KEYS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert got["frames"] == 6


def test_cli_serve_on_the_artifact_writes_the_pth_maps(art, loaded_once):
    dirs = []
    for ckpt in (art["path"], art["pth"]):
        out = art["tmp"] / f"served_{Path(ckpt).suffix[1:]}"
        assert cli.main(["serve", "--split", str(art["split"]),
                         "--checkpoint", str(ckpt), "--out", str(out),
                         "--serve-batch", "4", "--device", "cpu",
                         *TINY_FLAGS]) == 0
        dirs.append(sorted(out.glob("*_depth.npy")))
    assert len(dirs[0]) == len(dirs[1]) == 6
    for a, b in zip(*dirs):
        np.testing.assert_allclose(np.load(a), np.load(b), rtol=1e-6)


def test_header_keys_are_the_jax_artifacts(art):
    """The keys of the header dict that ``export_serving_artifact`` of the
    JAX package writes, read from its source."""
    src = Path(camradepth_tpu.__file__).parent / "interop" / "hlo_export.py"
    keys = None
    for node in ast.walk(ast.parse(src.read_text())):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets
                     if isinstance(t, ast.Name)] == ["header"]):
            keys = {k.value for k in node.value.keys}
    header, blob_bytes = X.read_header(str(art["path"]))
    assert keys and set(header) == keys
    assert header["format"] == "camradepth-torch-export"
    assert header["img_size"] == list(HW) and header["input_channels"] == 7
    assert blob_bytes > 0


def _rewrite(src: Path, dst: Path, magic=None, header=None, flip=False):
    raw = src.read_bytes()
    (n,) = struct.unpack("<Q", raw[8:16])
    hdr = json.loads(raw[16:16 + n])
    hdr.update(header or {})
    blob = bytearray(raw[16 + n:])
    if flip:
        blob[len(blob) // 2] ^= 1
    h = json.dumps(hdr).encode()
    dst.write_bytes((magic or raw[:8]) + struct.pack("<Q", len(h)) + h
                    + bytes(blob))
    return dst


@pytest.mark.parametrize("case,match", [
    ("corrupt", "program hash mismatch"),
    ("bad_magic", "not a camradepth serving artifact"),
    ("geometry", "does not match the config"),
    ("jax", "JAX StableHLO artifact"),
])
def test_refusals(art, case, match):
    dst = art["tmp"] / f"{case}.bin"
    cfg = art["cfg"]
    if case == "corrupt":
        _rewrite(art["path"], dst, flip=True)
    elif case == "bad_magic":
        _rewrite(art["path"], dst, magic=b"NOTMAGIC")
    elif case == "geometry":
        dst = art["path"]
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    img_size=(32, 64)))
    else:  # a file of the JAX package's layout
        h = json.dumps({"format": "camradepth-stablehlo"}).encode()
        dst.write_bytes(b"CRDSHLO1" + struct.pack("<Q", len(h)) + h + b"x")
    with pytest.raises(ValueError, match=match):
        X.artifact_engine(str(dst), cfg, device="cpu")
    if case == "corrupt":
        with pytest.raises(ValueError, match=match):
            X.load_serving_artifact(str(dst), "cpu")
    if case == "jax":  # a one-line CLI error, exit code 2
        assert X.is_artifact(str(dst))
        assert cli.main(["test", "--split", str(art["split"]),
                         "--checkpoint", str(dst), "--device", "cpu",
                         *TINY_FLAGS]) == 2


def test_cli_export_pth_and_the_refusals(art, capsys):
    out = art["tmp"] / "again.pth"
    assert cli.main(["export", "--checkpoint", str(art["pth"]), "--out",
                     str(out), "--device", "cpu", *TINY_FLAGS]) == 0
    saved = torch.load(out, weights_only=True)
    assert saved["lr"] == ExperimentConfig().train.learning_rate
    want = art["model"].state_dict()
    assert saved["state_dict"].keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(saved["state_dict"][k], v), k
    capsys.readouterr()
    refused = [
        ["export", "--checkpoint", str(art["pth"]), "--out", str(out),
         "--tpu-decoder"],
        ["serve", "--split", str(art["split"]), "--checkpoint",
         str(art["path"]), "--wire", "on"],
        ["test", "--split", str(art["split"]), "--checkpoint",
         str(art["tmp"] / "ckpt_orbax")],
        ["export", "--checkpoint", str(art["path"]), "--out", str(out),
         "--format", "artifact"],
    ]
    for argv in refused:
        assert cli.main([*argv, "--device", "cpu", *TINY_FLAGS]) == 2, argv
    err = capsys.readouterr().err.splitlines()
    assert len(err) == len(refused)
    assert "--format artifact (its deployment path)" in err[0]
    assert "use wire auto or off" in err[1]
    assert "camradepth_tpu.cli export --format pth" in err[2]
    assert ".pth checkpoints only" in err[3]
