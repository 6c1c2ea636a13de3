"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled on its own by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, and loaded
with ``ctypes``. No PyTorch header is included, so a build takes seconds.
All sources are compiled in parallel at the first use of any kernel, into
``build/kernels/<hash>/`` at the root of the checkout, keyed by a hash of
the sources and the flags: an edited source builds anew, an unchanged one
is reused. Nothing is built when the package is imported.

Every C entry point returns its ``cudaError_t``; :func:`check` raises when
it is not 0. Pointers and the stream are passed as ``c_void_p``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C signature of every entry point, by library (source stem).
SIGNATURES: Dict[str, Dict[str, list]] = {
    "maxpool_attention_scores": {
        **{
            # (q, k, out, B, N, M, C, heads, scale, stream)
            f"maxpool_attention_scores_{t}": [_P, _P, _P, _I, _I, _I, _I,
                                              _I, _F, _P]
            for t in ("f32", "bf16")
        },
        **{
            # (q, k, out, amax, B, N, M, C, heads, scale, stream)
            f"maxpool_attention_scores_argmax_{t}": [_P, _P, _P, _P, _I, _I,
                                                     _I, _I, _I, _F, _P]
            for t in ("f32", "bf16")
        },
    },
    "maxpool_attention_scores_bwd": {
        # (q, k, amax, g, dq, dk, partial, slotmap, B, N, M, C, heads,
        #  tokens, chunks, slots, smem, scale, stream)
        f"maxpool_attention_scores_bwd_{t}": [_P] * 8 + [_I] * 9 + [_F, _P]
        for t in ("f32", "bf16")
    },
    "upsample_bicubic_x2": {
        # (x, y, B, H, W, C, tw, rows, stream)
        f"upsample_bicubic_x2_{t}": [_P, _P, _I, _I, _I, _I, _I, _I, _P]
        for t in ("f32", "bf16")
    },
    "upsample_bicubic_x2_bwd": {
        # (gy, gx, B, H, W, C, threads, tiles, rows, grid x, grid y, rowcap,
        #  ocap, smem, stream)
        f"upsample_bicubic_x2_bwd_{t}": [_P, _P] + [_I] * 12 + [_P]
        for t in ("f32", "bf16")
    },
    "conv3x3_fused": {
        # (ptrs, meta, n_src, w, out, partial, stats, B, H, W, K, N, stream)
        f"conv3x3_fused_{t}": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _P]
        for t in ("f32", "bf16")
    },
    # (x, y, n, stream) and (x, gy, gx, n, stream)
    "gelu_bf16": {"gelu_bf16": [_P, _P, _L, _P],
                  "gelu_bf16_bwd": [_P, _P, _P, _L, _P]},
}

# Device types on which a kernel operator launches nothing: the CPU runs
# its plain version, ``meta`` its fake (shapes only, as
# ``utils/roofline.py`` records a forward). A wrapper checks a tensor on
# any other device as the kernel takes it.
NO_KERNEL = ("cpu", "meta")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """Where the libraries of the current sources and flags are built."""
    return BUILD_ROOT / _source_hash()


def _build_all() -> None:
    """Compile every source that has no library yet, all at once."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = {}
    for name in SIGNATURES:
        lib = out_dir / f"lib{name}.so"
        if not lib.is_file():
            todo[name] = lib
    procs = {}
    if todo:
        nvcc = nvcc_path()
        for name, lib in todo.items():
            # pid-unique temp name, renamed into place: processes that
            # build at the same time never load a half-written library
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():  # wait for every nvcc
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {name}.cu "
                          f"(exit {proc.returncode}):\n{err}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name, sigs in SIGNATURES.items():
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.camradepth_cuda_error_string.argtypes = [ctypes.c_int]
        lib.camradepth_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build (or reuse) and load every kernel library."""
    with _lock:
        if not _libs:
            _build_all()
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``; the first call builds all."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all()[name]


def launch(name: str, fn: str, device, *args) -> None:
    """Call C entry point ``fn`` of library ``name`` with ``args`` and the
    current stream of CUDA ``device``, and raise on the error it returns.
    The device is made current only when it is not already: the context
    switch costs more host time than a small kernel takes on the card."""
    import torch

    lib = library(name)
    if device.index is None or device.index == torch.cuda.current_device():
        err = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = getattr(lib, fn)(*args,
                                   torch.cuda.current_stream().cuda_stream)
    check(lib, err, name)


def register_op(name: str, schema: str, cpu, cuda, fake):
    """Define the operator ``torch.ops.camradepth.<name>`` with ``schema``,
    ``cpu`` (the plain version) and ``cuda`` (the kernel) as its
    implementations and ``fake`` giving its output's shape and dtype, and
    return it. An operator of its own stays in a ``torch.export`` graph
    (``interop/export.py``), so an artifact launches the kernel on the
    card. ``torch.library.custom_op`` registers the same operator, but its
    first call in a process imports ``torch._dynamo`` (some 2 s)."""
    import torch

    qualname = f"camradepth::{name}"
    torch.library.define(qualname, schema)
    torch.library.impl(qualname, "cpu", cpu)
    torch.library.impl(qualname, "cuda", cuda)
    torch.library.register_fake(qualname, fake)
    return getattr(torch.ops.camradepth, name).default


def register_vmap(name: str, rule) -> None:
    """Give the operator ``torch.ops.camradepth.<name>`` its
    ``torch.func.vmap`` rule ``rule(info, in_dims, *args) -> (outputs,
    out_dims)``. The rules fold the vmapped dimension into the operator's
    own batch dimension (``fold``/``unfold``), so a call over T trials of a
    B-sample batch is one call over T*B samples: one kernel launch on the
    card, the plain version on the CPU."""
    import torch

    torch.library.register_vmap(f"camradepth::{name}", rule)


def batch_first(info, in_dims, *tensors):
    """``tensors`` with their vmapped dimension first, an unbatched one
    (its in_dim None) expanded to ``info.batch_size`` along it."""
    return tuple(
        t.movedim(d, 0) if d is not None
        else t.expand(info.batch_size, *t.shape)
        for t, d in zip(tensors, in_dims))


def fold(t):
    """[T, B, ...] -> [T*B, ...]."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


def unfold(t, trials: int):
    """[T*B, ...] -> [T, B, ...]."""
    return t.reshape(trials, t.shape[0] // trials, *t.shape[1:])


def needs_grad(*tensors) -> bool:
    """Whether gradients must flow through a call on ``tensors``."""
    import torch

    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_autograd(what: str, *tensors) -> None:
    """Raise when an inference-only kernel would cut the autograd graph: a
    CUDA call that gradients would have to flow through is an error, not
    a silently detached result. Run it under ``torch.inference_mode()`` or
    ``torch.no_grad()``."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel is inference-only (it has no "
            "backward) and would return a result detached from the "
            "autograd graph; call it under torch.inference_mode() or "
            "torch.no_grad()"
        )


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point of ``lib`` returned a CUDA error."""
    if err != 0:
        msg = lib.camradepth_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")
