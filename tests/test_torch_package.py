"""Package rules of the PyTorch port (camradepth_tpu_torch): it imports
neither JAX nor the JAX package, builds nothing at import, runs on the card
unless asked for the CPU, and counts kernel launches only on the card."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import camradepth_tpu_torch
from camradepth_tpu_torch.config import ExperimentConfig, ModelConfig
from camradepth_tpu_torch.ops.attention import maxpool_attention_scores
from camradepth_tpu_torch.ops.resize import upsample_bicubic_x2
from tests.torch_port import one_torch_thread  # noqa: F401

PKG = Path(camradepth_tpu_torch.__file__).parent
ROOT = PKG.parent
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py"
)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex",
             "camradepth_tpu")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.fixture(scope="module", autouse=True)
def fresh_imports():
    """A fresh interpreter that imports every module of the package and
    prints ``sys.modules``, started with the module so that its other tests
    run meanwhile; ``test_every_module_imports_without_jax``, the module's
    last test, reads it."""
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_sources_import_no_jax():
    bad = []
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad
    assert len(MODULES) >= 11
    assert {"camradepth_tpu_torch.serving_http",
            "camradepth_tpu_torch.interop.export",
            "camradepth_tpu_torch.parallel.multihost",
            "camradepth_tpu_torch.parallel.mesh",
            "camradepth_tpu_torch.parallel.gradcheck",
            "camradepth_tpu_torch.parallel.spatial",
            "camradepth_tpu_torch.train.search",
            "camradepth_tpu_torch.geometry.se3",
            "camradepth_tpu_torch.geometry.raster",
            "camradepth_tpu_torch.ops.optical_flow",
            "camradepth_tpu_torch.models.alt_blocks",
            "camradepth_tpu_torch.models.raft",
            "camradepth_tpu_torch.models.panoptic_deeplab",
            "camradepth_tpu_torch.dataprep.stages",
            "camradepth_tpu_torch.dataprep.radar_fusion",
            "camradepth_tpu_torch.dataprep.lidar_fusion",
            "camradepth_tpu_torch.dataprep.adapters",
            "camradepth_tpu_torch.dataprep.pipeline",
            "camradepth_tpu_torch.viz",
            "camradepth_tpu_torch.bench",
            "camradepth_tpu_torch.utils.roofline",
            "camradepth_tpu_torch.utils.scaling",
            "camradepth_tpu_torch.utils.profiling"} <= set(MODULES)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.serving import DepthEngine, load_engine

    cfg = ExperimentConfig(model=ModelConfig(
        img_size=(64, 128), dims=(16, 32, 32, 64), depths=(1, 1, 1, 1),
        compute_dtype="float32"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model(cfg.model)
    model = create_model(cfg.model, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DepthEngine(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_engine(cfg, "no_such_checkpoint.pth")
    from camradepth_tpu_torch.interop.export import load_serving_artifact

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_serving_artifact("no_such_artifact.pt2")
    from camradepth_tpu_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg)
    from camradepth_tpu_torch.models import panoptic_deeplab, raft
    from camradepth_tpu_torch.ops.optical_flow import lk_flow
    from camradepth_tpu_torch.train.search import vmapped_trials

    im = np.zeros((16, 16, 3), np.uint8)
    for call in (lambda: lk_flow(im, im),
                 lambda: raft.raft_flow_fn({}),
                 lambda: panoptic_deeplab.classmap_fn(torch.nn.Module()),
                 lambda: vmapped_trials(cfg, {}, batches=[{}])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("tpu_decoder", [False, True])
@pytest.mark.parametrize("name", ["supervised_seg", "unsupervised_seg",
                                  "sup_unsup_seg", "sup_unsup_seg_rgb"])
def test_seg_presets_build_with_either_decoder(name, tpu_decoder):
    """Each seg preset at its full widths builds (on the meta device: the
    structure, no weights), with its seg heads, and with the tpu_decoder
    stages in place of the parity ones when asked."""
    import dataclasses

    from camradepth_tpu_torch.config import preset
    from camradepth_tpu_torch.models.camradepth import CamRaDepth
    from camradepth_tpu_torch.models.layers import Decoder, TPUDecoder

    cfg = dataclasses.replace(preset(name).model, tpu_decoder=tpu_decoder)
    with torch.device("meta"):
        model = CamRaDepth(cfg)
    keys = model.state_dict().keys()
    stage = TPUDecoder if tpu_decoder else Decoder
    assert all(isinstance(m, stage) for m in (
        model.depth_upsample[3], model.depth_upsample[4],
        *model.seg_upsample))
    assert ("seg_conv_final.weight" in keys) == cfg.supervised_seg
    assert ("unsup_final.weight" in keys) == cfg.unsupervised_seg
    assert model.dest_encoder.patch_embed1.proj.in_channels == (
        cfg.input_channels)


def test_config_maps_field_for_field_from_jax_config():
    from camradepth_tpu.config import MeshConfig as JaxMeshConfig
    from camradepth_tpu.config import preset as jax_preset
    from camradepth_tpu.config import tiny_test_config as jax_tiny
    from camradepth_tpu_torch.config import MeshConfig, TrainConfig, preset
    from camradepth_tpu_torch.config import tiny_test_config

    for name in ("base", "base_rgb", "sup_unsup_seg"):
        jm, tm = jax_preset(name).model, preset(name).model
        for f in ModelConfig.__dataclass_fields__:
            assert getattr(tm, f) == getattr(jm, f), (name, f)
        assert preset(name).data.max_depth == jax_preset(name).data.max_depth
        # every TrainConfig field of the port is the JAX one, by default
        jt, tt = jax_preset(name).train, preset(name).train
        for f in TrainConfig.__dataclass_fields__:
            assert getattr(tt, f) == getattr(jt, f), (name, f)
        assert tt.update_interval == jt.update_interval == 3
        # the mesh section, field for field
        assert ([f for f in MeshConfig.__dataclass_fields__]
                == [f for f in JaxMeshConfig.__dataclass_fields__])
        jm, tm = jax_preset(name).mesh, preset(name).mesh
        for f in MeshConfig.__dataclass_fields__:
            assert getattr(tm, f) == getattr(jm, f), (name, f)
    for f in TrainConfig.__dataclass_fields__:
        assert getattr(tiny_test_config().train, f) == getattr(
            jax_tiny().train, f), f


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (maxpool_attention_scores.launches, upsample_bicubic_x2.launches)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 8, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 3, 32)).astype(np.float32))
    maxpool_attention_scores(q, k, 2, 0.25)
    upsample_bicubic_x2(q.reshape(1, 2, 4, 32))
    assert (maxpool_attention_scores.launches,
            upsample_bicubic_x2.launches) == before == (0, 0)


def test_kernel_wrappers_reject_mixed_devices():
    q = torch.zeros(1, 4, 8)
    k = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        maxpool_attention_scores(q, k, 1, 1.0)
    # a meta tensor goes to the operator's fake, as the roofline's forward
    # (utils/roofline.py) runs it: shapes only, no launch
    before = upsample_bicubic_x2.launches
    y = upsample_bicubic_x2(torch.zeros(1, 2, 2, 1, device="meta"))
    assert y.device.type == "meta" and tuple(y.shape) == (1, 4, 4, 1)
    s = maxpool_attention_scores(q.to("meta"), k, 1, 1.0)
    assert s.device.type == "meta" and tuple(s.shape) == (1, 4)
    assert upsample_bicubic_x2.launches == before


def test_every_module_imports_without_jax(fresh_imports):
    out, err = fresh_imports.communicate(timeout=120)
    assert fresh_imports.returncode == 0, err
    loaded = out.split()
    for m in ("serving", "serving_http", "interop.export", "viz", "bench",
              "utils.roofline", "utils.scaling", "utils.profiling"):
        assert f"camradepth_tpu_torch.{m}" in loaded, m
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad
