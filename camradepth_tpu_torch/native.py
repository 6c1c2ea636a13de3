"""The native host code: bindings of ``csrc/host/rasterize.cc``.

The package's own counterpart of ``camradepth_tpu/native.py``: the
loader's frame-assembly and wire sections, and the min-depth raster of the
offline prep (``dataprep/lidar_fusion.py``). The C++ source is compiled
with g++ at its first use (never at import) into ``build/native/<hash>/``
at the root of the checkout, where the hash keys the source, the flags and
``g++ --version``: an edited source or another compiler builds anew, an
unchanged one is reused. The build holds a lock across threads (a loader's
workers reach the first use together) and writes under a temporary name
that it then renames, so processes that build at the same time never load
a half-written library.

There is no silent fallback: where g++ is missing or fails,
:func:`library` raises :class:`NativeCompileError`. The loader has a numpy
path that ``DataConfig.native_assemble=false`` selects; the prep's raster
has none (the JAX package falls back to numpy there, silently). The numpy
versions of the raster, :func:`raster_min_depth_numpy` and
:func:`quantize_pixels_numpy`, are the plain versions that the tests hold
the native ones to; nothing on the prep's path calls them. The library is
loaded with ``ctypes.CDLL``, which releases the interpreter lock for each
call, so the loader's worker threads run these passes in parallel; numpy's
ufuncs keep the lock between passes.

Every function is bit for bit with the numpy path it stands for
(``data/channels.py``, ``data/wire.py``, the numpy raster here;
``tests/test_torch_native.py``, ``tests/test_torch_dataprep.py``).
:data:`counts` tells how many frames each loader path assembled or
encoded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "host" / "rasterize.cc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "native"
GXX = "g++"
# -ffp-contract=off: GCC would otherwise fuse a multiply and an add into an
# FMA wherever the target has one (baseline on aarch64), which rounds once
# where numpy rounds twice
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# how the library was had: {"path", "gxx", "seconds"} (0.0 when reused)
build_info: Dict[str, object] = {}

# frames that each path assembled (data/channels.py) or encoded
# (data/wire.py); a frame that the native path refuses counts as numpy
counts: Dict[str, int] = {"assemble_native": 0, "assemble_numpy": 0,
                          "wire_native": 0, "wire_numpy": 0}
_count_lock = threading.Lock()


def count(key: str) -> None:
    with _count_lock:
        counts[key] += 1


def reset_counts() -> None:
    with _count_lock:
        for key in counts:
            counts[key] = 0


class NativeCompileError(RuntimeError):
    pass


def _refuse(why: str) -> NativeCompileError:
    return NativeCompileError(
        f"the native host code ({SRC.name}) could not be built: {why}; "
        "install g++ (the loader alone can do without it: set "
        "data.native_assemble=false to assemble frames with numpy)")


def _gxx_version() -> str:
    try:
        proc = subprocess.run([GXX, "--version"], capture_output=True,
                              text=True, timeout=60)
    except OSError as e:
        raise _refuse(f"{GXX}: {e}") from e
    if proc.returncode != 0:
        last = (proc.stderr.strip().splitlines() or [""])[-1]
        raise _refuse(f"{GXX} --version exited {proc.returncode}: {last}")
    return proc.stdout.strip()


def _build() -> ctypes.CDLL:
    version = _gxx_version()
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(version.encode())
    lib_path = BUILD_ROOT / h.hexdigest()[:16] / "libcamradepth_host.so"
    t0 = time.perf_counter()
    built = not lib_path.is_file()
    if built:
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [GXX, *GXX_FLAGS, "-o", str(tmp), str(SRC)],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            last = (proc.stderr.strip().splitlines() or [""])[-1]
            raise _refuse(f"{GXX} exited {proc.returncode}: {last}")
        os.replace(tmp, lib_path)
    seconds = time.perf_counter() - t0 if built else 0.0
    lib = ctypes.CDLL(str(lib_path))
    _bind(lib)
    build_info.update(path=str(lib_path), gxx=version.splitlines()[0],
                      seconds=seconds)
    return lib


def library() -> ctypes.CDLL:
    """The loaded library; the first call builds it (or reuses a build of
    the same source, flags and compiler). Raises
    :class:`NativeCompileError` where g++ is missing or fails."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _build()
    return _lib


def _bind(lib: ctypes.CDLL) -> None:
    """The C signature of every entry point (``camradepth_tpu/native.py:
    79-163``)."""
    i64, i32, f32, f64 = (ctypes.c_int64, ctypes.c_int32, ctypes.c_float,
                          ctypes.c_double)
    i64p, f64p, u8p, f32p, i32p = (ctypes.POINTER(t) for t in (
        i64, f64, ctypes.c_uint8, f32, i32))
    sigs = {
        "raster_min_depth": ([i64p, f64p, f64p, i64, i64, i64, f64p, f64p],
                             None),
        "quantize_pixels": (
            [f64p, f64p, u8p, i64, f64, i64, i64, i64p, f64p, f64p], None),
        "raster_min_depth_batch": (
            [i64p, f64p, f64p, i64p, i64, i64, i64, f64p, f64p, i64], None),
        "assemble_normalize_u8": ([u8p, i64, f32p, f32p, f32p, i64], None),
        "assemble_scale_clip_f32": (
            [f32p, i64, i64, i64, i64, ctypes.c_int, f32, f32, f32, f32p,
             i64], None),
        "assemble_scale_clip_f64": (
            [f64p, i64, i64, i64, i64, ctypes.c_int, f64, f64, f64, f32p,
             i64], None),
        "encode_inverse_depth_f32": ([f32p, i64, f32, f32p], None),
        "encode_inverse_depth_f64": ([f64p, i64, f64, f32p], None),
        "gather_rows_cols_i64_to_i32": (
            [i64p, i64, i64p, i64p, i64, i64, i32p], None),
        "gather_rows_cols_i32_to_i32": (
            [i32p, i64, i64p, i64p, i64, i64, i32p], None),
        "wire_union_nonzero_f32": ([f32p, i64] * 4 + [i64, i32p, i64], i64),
        "wire_union_nonzero_f64": ([f64p, i64] * 4 + [i64, i32p, i64], i64),
        "wire_gather_f32": (
            [f32p, i64, i32p, i64, ctypes.c_int, f32, f32, f32, f32p, i64],
            None),
        "wire_gather_f64": (
            [f64p, i64, i32p, i64, ctypes.c_int, f64, f64, f64, f32p, i64],
            None),
        "wire_gt_sparse_f32": ([f32p, i64, i64, f32, i32p, f32p, i64], i64),
        "wire_gt_sparse_f64": ([f64p, i64, i64, f64, i32p, f32p, i64], i64),
        "gather_rows_cols_i64_to_u8": (
            [i64p, i64, i64p, i64p, i64, i64, u8p], ctypes.c_int),
        "gather_rows_cols_i32_to_u8": (
            [i32p, i64, i64p, i64p, i64, i64, u8p], ctypes.c_int),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def _ptr(a: np.ndarray, ctype):
    """A pointer to the first element of ``a`` (an interior pointer for a
    view such as ``out2d[:, col:]``)."""
    return a.ctypes.data_as(ctypes.POINTER(ctype))


_FLOAT = {np.dtype(np.float32): ("f32", ctypes.c_float),
          np.dtype(np.float64): ("f64", ctypes.c_double)}
_INT = {np.dtype(np.int64): ("i64", ctypes.c_int64),
        np.dtype(np.int32): ("i32", ctypes.c_int32)}


def _float(a: np.ndarray):
    if a.dtype not in _FLOAT:  # callers check dtypes first
        raise TypeError(f"unsupported dtype {a.dtype}")
    return _FLOAT[a.dtype]


# ---------------------------------------------------------------------------
# Min-depth raster (dataprep/lidar_fusion.py lidar_maps)


def _points(a, dtype, n: int) -> np.ndarray:
    """``a`` as a C-order array of ``n`` values of ``dtype``: the C code
    reads n of every per-point array."""
    a = np.ascontiguousarray(a, dtype)
    if a.shape != (n,):
        raise ValueError(f"expected {n} points, got an array of {a.shape}")
    return a


def _payload_columns(payload: Dict[str, np.ndarray], n: int):
    """(names, widths, the [n, C] float64 C-order matrix) of a payload; a
    frame with no points keeps its channels' widths."""
    names = list(payload)
    arrays = [np.asarray(payload[k], np.float64) for k in names]
    cols = [a.reshape(n, int(np.prod(a.shape[1:]))) for a in arrays]
    widths = [c.shape[1] for c in cols]
    flat = (np.ascontiguousarray(np.concatenate(cols, axis=1))
            if sum(widths) else np.zeros((n, 0)))
    return names, widths, flat


def _payload_maps(out: np.ndarray, names, widths) -> Dict[str, np.ndarray]:
    """The [..., C] raster payload cut back into its named maps; a map of
    width 1 comes back flat."""
    maps, off = {}, 0
    for k, w in zip(names, widths):
        chunk = out[..., off: off + w]
        maps[k] = chunk[..., 0] if w == 1 else chunk
        off += w
    return maps


def raster_min_depth_host(
    pix: np.ndarray,
    depth: np.ndarray,
    payload: Dict[str, np.ndarray],
    num_pixels: int,
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Min-depth-wins scatter on the host: the contract of
    ``geometry.raster.raster_min_depth``, with invalid points marked by
    ``pix < 0`` (or ``>= num_pixels``). Of equal depths the first point
    wins. Depth and payloads are float64; a payload of width 1 comes back
    flat. Returns (depth map [num_pixels], {name: map})."""
    n = len(depth)
    names, widths, flat = _payload_columns(payload, n)
    pix = _points(pix, np.int64, n)
    depth = np.ascontiguousarray(depth, np.float64)
    out_depth = np.zeros(num_pixels, np.float64)
    out_payload = np.zeros((num_pixels, flat.shape[1]), np.float64)
    library().raster_min_depth(
        _ptr(pix, ctypes.c_int64), _ptr(depth, ctypes.c_double),
        _ptr(flat, ctypes.c_double), n, flat.shape[1], num_pixels,
        _ptr(out_depth, ctypes.c_double), _ptr(out_payload, ctypes.c_double))
    return out_depth, _payload_maps(out_payload, names, widths)


def raster_min_depth_batch_host(
    pix: np.ndarray,
    depth: np.ndarray,
    payload: Dict[str, np.ndarray],
    offsets: np.ndarray,
    num_pixels: int,
    n_threads: int = 1,
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """:func:`raster_min_depth_host` of F frames at once: frame f's points
    are ``[offsets[f], offsets[f + 1])`` of the flat arrays, its maps row f
    of the outputs; the frames are split over ``n_threads`` threads."""
    n = len(depth)
    names, widths, flat = _payload_columns(payload, n)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n_frames = len(offsets) - 1
    if n_frames < 0 or offsets[0] != 0 or offsets[-1] != n or (
            np.diff(offsets) < 0).any():
        raise ValueError(f"offsets must rise from 0 to the {n} points")
    pix = _points(pix, np.int64, n)
    depth = np.ascontiguousarray(depth, np.float64)
    out_depth = np.zeros((n_frames, num_pixels), np.float64)
    out_payload = np.zeros((n_frames, num_pixels, flat.shape[1]), np.float64)
    library().raster_min_depth_batch(
        _ptr(pix, ctypes.c_int64), _ptr(depth, ctypes.c_double),
        _ptr(flat, ctypes.c_double), _ptr(offsets, ctypes.c_int64),
        n_frames, flat.shape[1], num_pixels,
        _ptr(out_depth, ctypes.c_double), _ptr(out_payload, ctypes.c_double),
        n_threads)
    return out_depth, _payload_maps(out_payload, names, widths)


def quantize_pixels_host(x, y, valid, scale: float, h_out: int, w_out: int):
    """Center-aligned quantization of full-resolution coordinates to
    ``h_out x w_out`` pixel ids, on the host: (pix [int64], xq, yq
    [float64]), pix -1 where ``valid`` is False."""
    n = len(x)
    x = np.ascontiguousarray(x, np.float64)
    y = _points(y, np.float64, n)
    v = _points(valid, np.uint8, n) if valid is not None else None
    pix = np.empty(n, np.int64)
    xq = np.empty(n, np.float64)
    yq = np.empty(n, np.float64)
    library().quantize_pixels(
        _ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double),
        _ptr(v, ctypes.c_uint8) if v is not None else None, n, scale, h_out,
        w_out, _ptr(pix, ctypes.c_int64), _ptr(xq, ctypes.c_double),
        _ptr(yq, ctypes.c_double))
    return pix, xq, yq


def raster_min_depth_numpy(pix, depth, payload, num_pixels):
    """The plain version of :func:`raster_min_depth_host` (the JAX
    package's numpy fallback, ``camradepth_tpu/native.py:203-213``): a
    stable lexicographic sort keeps each pixel's least depth, first
    point first."""
    n = len(depth)
    names, widths, flat = _payload_columns(payload, n)
    pix = np.ascontiguousarray(pix, np.int64)
    depth = np.ascontiguousarray(depth, np.float64)
    out_depth = np.zeros(num_pixels, np.float64)
    out_payload = np.zeros((num_pixels, flat.shape[1]), np.float64)
    order = np.lexsort((np.arange(n), depth, pix))
    pid_s = pix[order]
    keep = np.concatenate([[True], pid_s[1:] != pid_s[:-1]])
    keep &= (pid_s >= 0) & (pid_s < num_pixels)
    tgt = pid_s[keep]
    out_depth[tgt] = depth[order][keep]
    if flat.shape[1]:
        out_payload[tgt] = flat[order][keep]
    return out_depth, _payload_maps(out_payload, names, widths)


def quantize_pixels_numpy(x, y, valid, scale: float, h_out: int,
                          w_out: int):
    """The plain version of :func:`quantize_pixels_host` (``camradepth_tpu/
    native.py:238-245``)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    xq = np.clip((x + 0.5) / scale - 0.5, 0, w_out - 1)
    yq = np.clip((y + 0.5) / scale - 0.5, 0, h_out - 1)
    pix = (np.round(yq).astype(np.int64) * w_out
           + np.round(xq).astype(np.int64))
    if valid is not None:
        pix = np.where(valid, pix, -1)
    return pix, xq, yq


# ---------------------------------------------------------------------------
# Frame assembly (data/channels.py _assemble_frame_native)


def normalize_image_into(img_u8: np.ndarray, mean: np.ndarray,
                         std: np.ndarray, out2d: np.ndarray,
                         col: int) -> None:
    """(u8/255 - mean)/std into out2d[:, col:col+3]; img_u8 [npix, 3]
    C-order."""
    npix, stride = out2d.shape
    library().assemble_normalize_u8(
        _ptr(img_u8, ctypes.c_uint8), npix, _ptr(mean, ctypes.c_float),
        _ptr(std, ctypes.c_float), _ptr(out2d[:, col:], ctypes.c_float),
        stride)


def scale_clip_into(src2d: np.ndarray, ch0: int, n_ch: int,
                    out2d: np.ndarray, col: int, use_clip: bool,
                    lo: float, hi: float, div: float) -> None:
    """out2d[:, col:col+n_ch] = clip?(src2d[:, ch0:ch0+n_ch], lo, hi) / div.

    src2d is C-contiguous [npix, in_ch] float32 or float64; the arithmetic
    runs in the input's precision and casts at the store, as numpy's
    ``np.clip(x, lo, hi) / div`` then ``.astype(float32)``."""
    npix, stride = out2d.shape
    t, ct = _float(src2d)
    getattr(library(), f"assemble_scale_clip_{t}")(
        _ptr(src2d, ct), npix, src2d.shape[1], ch0, n_ch, int(use_clip),
        lo, hi, div, _ptr(out2d[:, col:], ctypes.c_float), stride)


def encode_inverse_depth_native(depth: np.ndarray,
                                max_depth: float) -> np.ndarray:
    """``channels.encode_inverse_depth`` of a C-order f32/f64 [H, W]."""
    out = np.empty(depth.shape, np.float32)
    t, ct = _float(depth)
    getattr(library(), f"encode_inverse_depth_{t}")(
        _ptr(depth, ct), depth.size, max_depth, _ptr(out, ctypes.c_float))
    return out


def _gather(img, ri, ci, out_dtype, out_ct, suffix):
    if img.dtype not in _INT:  # callers check dtypes first
        raise TypeError(f"unsupported dtype {img.dtype}")
    t, ct = _INT[img.dtype]
    out = np.empty((len(ri), len(ci)), out_dtype)
    ri = np.ascontiguousarray(ri, np.int64)
    ci = np.ascontiguousarray(ci, np.int64)
    rc = getattr(library(), f"gather_rows_cols_{t}_to_{suffix}")(
        _ptr(img, ct), img.shape[1], _ptr(ri, ctypes.c_int64),
        _ptr(ci, ctypes.c_int64), len(ri), len(ci), _ptr(out, out_ct))
    return out, rc


def gather_resize_i32(img: np.ndarray, ri: np.ndarray,
                      ci: np.ndarray) -> np.ndarray:
    """img[np.ix_(ri, ci)].astype(int32) for an int32/int64 label map."""
    return _gather(img, ri, ci, np.int32, ctypes.c_int32, "i32")[0]


# ---------------------------------------------------------------------------
# Wire encode (data/wire.py _encode_frame_wire_native)


def wire_union_nonzero(sources, npix: int, out_idx: np.ndarray) -> int:
    """Ascending indices of the pixels where any strided source is nonzero
    (NaN is, -0.0 is not: numpy's ``!= 0``).

    ``sources``: up to 4 (array, element stride) of one float dtype.
    Writes at most ``len(out_idx)`` indices and returns the true count
    (an overflow is a count above the cap)."""
    if len(sources) > 4:  # the wire has at most 4 radar channels
        raise ValueError("at most 4 union sources")
    t, ct = _float(sources[0][0])
    args = []
    for base, stride in sources:
        args += [_ptr(base, ct), stride]
    args += [None, 0] * (4 - len(sources))
    return int(getattr(library(), f"wire_union_nonzero_{t}")(
        *args, npix, _ptr(out_idx, ctypes.c_int32), len(out_idx)))


def wire_gather(base: np.ndarray, stride: int, idx: np.ndarray, n: int,
                use_clip: bool, lo: float, hi: float, div: float,
                out: np.ndarray, out_offset: int, out_stride: int) -> None:
    """out.flat[out_offset::out_stride][:n] = clip?(base[idx*stride])/div,
    in the source's dtype, f32 at the store (numpy's operation order)."""
    assert out.dtype == np.float32 and out.flags.c_contiguous
    t, ct = _float(base)
    optr = ctypes.cast(out.ctypes.data + out_offset * 4,
                       ctypes.POINTER(ctypes.c_float))
    getattr(library(), f"wire_gather_{t}")(
        _ptr(base, ct), stride, _ptr(idx, ctypes.c_int32), n, int(use_clip),
        lo, hi, div, optr, out_stride)


def wire_gt_sparse(depth: np.ndarray, stride: int, npix: int,
                   max_depth: float, out_idx: np.ndarray,
                   out_val: np.ndarray) -> int:
    """The inverse-depth encode and its sparsify in one pass over a strided
    f32/f64 depth view; returns the true point count."""
    t, ct = _float(depth)
    return int(getattr(library(), f"wire_gt_sparse_{t}")(
        _ptr(depth, ct), stride, npix, max_depth,
        _ptr(out_idx, ctypes.c_int32), _ptr(out_val, ctypes.c_float),
        len(out_idx)))


def gather_resize_u8(img: np.ndarray, ri: np.ndarray,
                     ci: np.ndarray) -> Optional[np.ndarray]:
    """img[np.ix_(ri, ci)].astype(uint8) for an int label map, or None
    where a value lies outside [0, 255] (the numpy path then raises its
    message)."""
    out, rc = _gather(img, ri, ci, np.uint8, ctypes.c_uint8, "u8")
    return None if rc else out
