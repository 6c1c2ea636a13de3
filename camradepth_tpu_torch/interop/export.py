"""Self-contained serving artifacts through ``torch.export``.

Counterpart of ``camradepth_tpu/interop/hlo_export.py``: the serving
forward (:class:`serving.ServingForward`: depth decoded to metres, argmax
seg labels) with the trained weights inside, exported by
``torch.export`` and saved with ``torch.export.save``. One file serves
with no model code, config or checkpoint conversion at load time. It is
also the deployment path of the ``tpu_decoder`` variant, which has no
reference-format ``.pth`` (``cli export --format pth`` refuses it).

The kernels are operators of their own (``camradepth::maxpool_attention_
scores``, ``camradepth::upsample_bicubic_x2``, ``camradepth::gelu_bf16``,
registered when ``camradepth_tpu_torch.ops`` is imported, as this module
does), so the exported graph holds them and not their plain versions: on
a CUDA device the artifact launches the Hopper kernels, on the CPU it runs
the plain versions. The program is stored on the CPU and moved at load
time (``torch.export.passes.move_to_device_pass``) to the device it
serves on, so an artifact exported on one device serves on the other.
Python branches on the device are fixed when the graph is traced: a bf16
model exported on the CPU keeps the CPU's fp32 convolution
(``models/layers.py`` ``Conv2d``) wherever it serves.

File layout: the magic ``CRDTEXP1``, an 8-byte little-endian header
length, a JSON header (the keys of ``hlo_export.py:89-102``, with
``"format": "camradepth-torch-export"`` and ``platforms`` the device the
program was traced on, then the other one it loads on), then the blob
that ``torch.export.save`` writes, whose sha256 the header carries and
the loader checks.
"""

from __future__ import annotations

import copy
import hashlib
import io
import json
import struct
import warnings
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
from torch.export.passes import move_to_device_pass

# the kernels' operators must be registered before a program is loaded
import camradepth_tpu_torch.ops.attention  # noqa: F401
import camradepth_tpu_torch.ops.gelu  # noqa: F401
import camradepth_tpu_torch.ops.resize  # noqa: F401
from camradepth_tpu_torch import resolve_device
from camradepth_tpu_torch.config import ExperimentConfig
from camradepth_tpu_torch.models.layers import GroupNorm

MAGIC = b"CRDTEXP1"
FORMAT = "camradepth-torch-export"
# the JAX package's StableHLO artifact (camradepth_tpu/interop/
# hlo_export.py), recognised only to be refused in one line
JAX_MAGIC = b"CRDSHLO1"
ARTIFACT_SUFFIXES = (".pt2", ".stablehlo", ".hlo")
PLATFORMS = ("cpu", "cuda")


def _weights_in(model: torch.nn.Module, artifact_dtype: str):
    """A copy of ``model`` with no gradients, and with
    ``artifact_dtype="bfloat16"`` every fp32 weight but the GroupNorm
    affines (which the forward reads in fp32) in bf16, as ``create_model``
    holds a bf16 model's weights: a bf16-compute model's artifact computes
    the live forward's values, an fp32 one's uses bf16-rounded weights."""
    model = copy.deepcopy(model).eval().requires_grad_(False)
    if artifact_dtype == "bfloat16":
        keep = {id(p) for m in model.modules() if isinstance(m, GroupNorm)
                for p in m.parameters()}
        for p in model.parameters():
            if id(p) not in keep and p.dtype == torch.float32:
                p.data = p.data.to(torch.bfloat16)
    return model


def export_program(
    cfg: ExperimentConfig,
    model: torch.nn.Module,
    batch_size: int = 8,
    decode_depth: bool = True,
    artifact_dtype: str = "float32",
    dynamic_batch: bool = False,
) -> torch.export.ExportedProgram:
    """The serving forward of ``model`` (a port ``CamRaDepth``, on the
    device to trace on) exported with its weights, the program moved to
    the CPU. ``artifact_dtype="bfloat16"`` holds the weights that the
    forward casts at use in bf16 (:func:`_weights_in`). ``dynamic_batch``
    exports a symbolic batch dimension: the program serves any batch
    size."""
    from camradepth_tpu_torch.serving import ServingForward

    if artifact_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"artifact_dtype must be float32 or bfloat16, got "
                         f"{artifact_dtype!r}")
    module = ServingForward(cfg, _weights_in(model, artifact_dtype),
                            decode_depth)
    dev = next(module.parameters()).device
    h, w = cfg.model.img_size
    # a traced batch of 1 would be specialised: trace at 2 or more
    b = max(2, batch_size) if dynamic_batch else batch_size
    x = torch.zeros((b, h, w, cfg.model.input_channels),
                    dtype=torch.float32, device=dev)
    dynamic = ({"x": {0: torch.export.Dim("batch", min=1)}}
               if dynamic_batch else None)
    with torch.no_grad():
        ep = torch.export.export(module, (x,), dynamic_shapes=dynamic)
    _drop_checks_and_identity_casts(ep.graph_module)
    ep = move_to_device_pass(ep, "cpu")
    ep._example_inputs = None  # a full input batch would double the file
    return ep


def _drop_checks_and_identity_casts(gm: torch.fx.GraphModule) -> None:
    """Take out of a traced graph what the trace itself guarantees: the
    dtype and device assertions that ``torch.export`` records beside every
    ``.to`` (1,298 in a bf16 ``base`` forward) and the casts to the dtype a
    tensor already has (381, which return their input). At ``base``'s
    depths the graph loses a fifth of its nodes, each of which saving,
    loading and every forward's host dispatch would pass over."""
    graph = gm.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target is torch.ops.aten.to.dtype and len(node.args) == 2
              and not node.kwargs
              and node.args[0].meta["val"].dtype == node.meta["val"].dtype):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    gm.recompile()


def export_serving_artifact(
    cfg: ExperimentConfig,
    model: torch.nn.Module,
    path: str,
    batch_size: int = 8,
    decode_depth: bool = True,
    artifact_dtype: str = "float32",
    dynamic_batch: bool = False,
) -> Dict:
    """Write the artifact of :func:`export_program` to ``path``; returns
    the header. A dynamic-batch artifact's header says ``batch_size:
    null``, and its consumer picks the serving batch;
    ``artifact_dtype="bfloat16"`` halves the file."""
    ep = export_program(cfg, model, batch_size, decode_depth,
                        artifact_dtype, dynamic_batch)
    traced_on = next(model.parameters()).device.type
    buf = io.BytesIO()
    with warnings.catch_warnings():
        # torch's writer warns for every weight that is not contiguous;
        # the channels_last conv weights are written with their strides
        warnings.filterwarnings("ignore", "No complete tensor found")
        torch.export.save(ep, buf)
    blob = buf.getvalue()
    h, w = cfg.model.img_size
    header = {
        "format": FORMAT,
        "version": 1,
        "batch_size": None if dynamic_batch else batch_size,
        "img_size": [h, w],
        "input_channels": cfg.model.input_channels,
        "decode_depth": decode_depth,
        "variant": cfg.name,
        "tpu_decoder": bool(cfg.model.tpu_decoder),
        "max_depth": float(cfg.data.max_depth),
        "platforms": [traced_on] + [p for p in PLATFORMS if p != traced_on],
        "artifact_dtype": artifact_dtype,
        "blob_sha256": hashlib.sha256(blob).hexdigest(),
    }
    hdr = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        f.write(blob)
    return header


def is_artifact(path: str) -> bool:
    """Whether ``path`` names a serving artifact, the port's or the JAX
    package's (which the loader refuses), by suffix or magic."""
    p = Path(path)
    if p.suffix in ARTIFACT_SUFFIXES:
        return True
    try:
        with open(p, "rb") as f:
            return f.read(len(MAGIC)) in (MAGIC, JAX_MAGIC)
    except OSError:
        return False


def _check_magic(path, magic: bytes) -> None:
    if magic == JAX_MAGIC:
        raise ValueError(
            f"{path} is a JAX StableHLO artifact (camradepth_tpu cli export "
            "--format stablehlo), which the port cannot run: export the "
            "checkpoint with `camradepth_tpu_torch.cli export --format "
            "artifact`")
    if magic != MAGIC:
        raise ValueError(
            f"{path} is not a camradepth serving artifact (bad magic; "
            "expected a `cli export --format artifact` output)")


def read_header(path: str) -> Tuple[Dict, int]:
    """The JSON header and the blob's size in bytes, without reading the
    program."""
    with open(path, "rb") as f:
        _check_magic(path, f.read(len(MAGIC)))
        (hdr_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hdr_len).decode())
        blob_bytes = (Path(path).stat().st_size - len(MAGIC) - 8 - hdr_len)
    return header, blob_bytes


class ArtifactForward:
    """The forward of a loaded artifact: ``fwd(x) -> {"depth", "seg"}``
    for a float32 ``[B, H, W, C]`` tensor on its device, under
    ``torch.inference_mode``; ``module`` is the program's graph module."""

    def __init__(self, module: torch.fx.GraphModule):
        self.module = module

    def __call__(self, x: torch.Tensor) -> Dict[str, Optional[torch.Tensor]]:
        with torch.inference_mode():
            out = self.module(x)
        return {"depth": out["depth"], "seg": out.get("seg")}


def load_serving_artifact(path: str, device="cuda"
                          ) -> Tuple[ArtifactForward, Dict]:
    """Load an artifact onto ``device`` -> ``(call, header)``; ``call``
    maps a float32 ``[B, H, W, C]`` tensor on that device to ``{"depth",
    "seg"}`` (depth in metres unless exported raw, seg labels or None). A
    file of the JAX package or of another format, or a blob whose sha256
    is not the header's, is refused."""
    dev = resolve_device(device)
    raw = Path(path).read_bytes()
    _check_magic(path, raw[: len(MAGIC)])
    off = len(MAGIC)
    (hdr_len,) = struct.unpack("<Q", raw[off: off + 8])
    off += 8
    header = json.loads(raw[off: off + hdr_len].decode())
    if header.get("format") != FORMAT:
        raise ValueError(f"{path}: header format {header.get('format')!r}, "
                         f"expected {FORMAT!r}")
    blob = raw[off + hdr_len:]
    if hashlib.sha256(blob).hexdigest() != header["blob_sha256"]:
        raise ValueError(
            f"{path} is corrupt: program hash mismatch (truncated copy or "
            "bit rot; export it again)")
    with warnings.catch_warnings():
        # the weights are read straight from the file's bytes, which are
        # not writable; nothing writes to them
        warnings.filterwarnings("ignore", "The given buffer is not writable")
        ep = torch.export.load(io.BytesIO(blob))
    return ArtifactForward(move_to_device_pass(ep, dev).module()), header


def check_geometry(header: Dict, cfg: ExperimentConfig) -> None:
    """Raise unless the artifact's input geometry is the config's."""
    want = (tuple(cfg.model.img_size), cfg.model.input_channels)
    got = (tuple(header["img_size"]), header["input_channels"])
    if want != got:
        raise ValueError(
            f"artifact geometry {got} does not match the config's {want}: "
            "pass the preset the artifact was exported from (header "
            f"variant: {header.get('variant')!r})")


def artifact_engine(
    path: str,
    cfg: Optional[ExperimentConfig] = None,
    decode_depth: Optional[bool] = None,
    batch_size: Optional[int] = None,
    device="cuda",
    mesh=None,
):
    """A ``DepthEngine`` on ``device`` serving an artifact. ``cfg`` is for
    bookkeeping only (the artifact is self-contained); when given, its
    geometry must be the header's, checked before the program is read.
    ``batch_size`` is the serving batch of a dynamic-batch artifact
    (default 8); a fixed one serves its own. The engine refuses a ``mesh``
    (an artifact's partitioning is fixed at export time)."""
    from camradepth_tpu_torch.serving import DepthEngine

    header, _ = read_header(path)
    if cfg is not None:
        check_geometry(header, cfg)
    if decode_depth is not None and decode_depth != header["decode_depth"]:
        raise ValueError(
            "decode_depth is baked into the artifact at export time "
            f"(exported with decode_depth={header['decode_depth']})")
    if cfg is None:
        from camradepth_tpu_torch.config import DataConfig, ModelConfig

        cfg = ExperimentConfig(
            model=ModelConfig(img_size=tuple(header["img_size"]),
                              input_channels=header["input_channels"]),
            data=DataConfig(max_depth=header["max_depth"]))
    call, header = load_serving_artifact(path, device)
    return DepthEngine(cfg, None,
                       batch_size=header["batch_size"] or batch_size or 8,
                       device=device, decode_depth=header["decode_depth"],
                       forward_fn=call, mesh=mesh)
