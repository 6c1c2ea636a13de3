"""Analytic attainable-roofline model of the forward on one NVIDIA H100.

Counterpart of ``camradepth_tpu/utils/roofline.py``: how fast could this
architecture run on this card? It answers with a per-frame floor that
``bench.py`` (``cli bench``) sets beside its measured time and ``cli
summary`` prints.

Method: run the forward on the ``meta`` device (shapes and dtypes only: no
weights, no card) under a ``TorchDispatchMode`` that records every aten
and kernel operator it reaches, and floor each one:

- matmul-class ops: ``aten.convolution`` (M = batch x output positions,
  K = kh*kw*Cin/groups, N = Cout), ``aten.mm``/``addmm``/``bmm``/``linear``
  and the max-pool attention scores' q.k^T product, counted with the M, K,
  N of the JAX package's XLA einsum (M = batch x heads x tokens, K = head
  dim, N = keys). Each one's floor is

      max(padded FLOPs / peak, bytes / HBM bandwidth)

  with M padded to 64, N to 8 and K to 16 in bf16 and fp16 (the tile of
  one ``wgmma``), and no padding in fp32, which runs outside the tensor
  cores (TF32 is off). Bytes are input + weight + output. The scores take
  the bound ``PERF.md`` section 6 gives their kernel: the bytes it moves
  (q and k read, the [B, N] fp32 scores written) and its FLOPs unpadded,
  since the kernel tiles its product itself. Depthwise convolutions (groups > 1)
  are bandwidth-only, as in the JAX model.
- the port's other Hopper kernel operators (bicubic x2, the bf16 GELU)
  take the bounds ``PERF.md`` section 6 uses: per launch, the larger of
  their bytes over the bandwidth and their fp32 operations over the fp32
  peak; a forward's bound is the sum over its launches. The fused conv is
  in no model, so no forward records it (``chip_smoke.py`` (f) bounds it).
- everything else is eager and unfused here: each remaining operator is
  counted once, as its input plus output bytes over the bandwidth, and the
  report labels that term "unfused eager bytes". Views move nothing and
  are not counted. The JAX model takes this term from XLA's post-fusion
  cost analysis instead; eager PyTorch has no counterpart of that count,
  so the two terms measure different things.

The result is a per-op table plus ``attainable_s``, and a caller divides
it by a measured time for a roofline share. It is a floor: launches, host
dispatch and on-chip traffic are not in it.

The card's numbers are NVIDIA's H100 SXM5 data sheet, dense (no
sparsity): 989 TFLOP/s bf16/fp16 tensor core, 67 TFLOP/s fp32, 3.35 TB/s
HBM3. An FLOP is one multiply or one add, so a multiply-add counts 2.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM5 data sheet, dense: bf16/fp16 tensor core, fp32 (the
# port's fp32 runs with TF32 off), HBM3 bandwidth
H100_PEAK_BF16 = 989e12
H100_PEAK_FP32 = 67e12
H100_HBM_BW = 3.35e12

# the tile of one wgmma in bf16/fp16: M 64, N a multiple of 8, K 16
WGMMA_M, WGMMA_N, WGMMA_K = 64, 8, 16

# fp32 operations per element of the bicubic x2 kernel's input (its two
# 4-tap passes for four outputs) and of the bf16 GELU kernel, and the
# bytes the bicubic moves per input byte (read once, four outputs
# written), as PERF.md section 6 and chip_smoke.py bound them
BICUBIC_OPS_PER_INPUT = 42.0
BICUBIC_BYTES_PER_INPUT_BYTE = 5
GELU_OPS_PER_ELEMENT = 20.0

_ATTENTION = "maxpool_attention_scores"


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def peak_for(dtype_bits: int) -> float:
    """The card's peak operations per second for products of this width."""
    return H100_PEAK_BF16 if dtype_bits <= 16 else H100_PEAK_FP32


@dataclass
class MatmulOp:
    kind: str                 # "conv" | "dot" | "dwconv"
    m: int                    # batch * output positions (or rows)
    k: int                    # reduction size
    n: int                    # output features
    bytes: int                # in + weights + out (a kernel's: what it moves)
    dtype_bits: int
    bw_only: bool = False     # depthwise: no tensor-core product
    kernel: Optional[str] = None  # the Hopper kernel that runs it, if one

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.k * self.n

    @property
    def padded_flops(self) -> float:
        # fp32 runs outside the tensor cores; a Hopper kernel of the port
        # tiles its product itself and takes PERF.md's bound, unpadded
        if self.dtype_bits > 16 or self.kernel:
            return self.flops
        return (2.0 * _ceil_to(self.m, WGMMA_M) * _ceil_to(self.k, WGMMA_K)
                * _ceil_to(self.n, WGMMA_N))

    @property
    def attainable_tflops(self) -> float:
        return peak_for(self.dtype_bits) * self.flops / self.padded_flops / 1e12

    @property
    def t_floor(self) -> float:
        if self.bw_only:
            return self.bytes / H100_HBM_BW
        return max(self.padded_flops / peak_for(self.dtype_bits),
                   self.bytes / H100_HBM_BW)


@dataclass
class KernelOp:
    """One launch of a Hopper kernel that is not a product."""

    name: str
    bytes: float
    ops: float
    ops_per_s: float = H100_PEAK_FP32

    @property
    def t_floor(self) -> float:
        return max(self.bytes / H100_HBM_BW, self.ops / self.ops_per_s)


@dataclass
class Roofline:
    matmuls: List[MatmulOp] = field(default_factory=list)
    kernels: List[KernelOp] = field(default_factory=list)
    other_bytes: float = 0.0  # unfused eager bytes, every other operator

    @property
    def t_matmul_floor(self) -> float:
        return float(sum(op.t_floor for op in self.matmuls))

    @property
    def t_kernel_floor(self) -> float:
        return float(sum(op.t_floor for op in self.kernels))

    @property
    def t_other_floor(self) -> float:
        return self.other_bytes / H100_HBM_BW

    @property
    def attainable_s(self) -> float:
        return self.t_matmul_floor + self.t_kernel_floor + self.t_other_floor

    def kernel_floors(self) -> Dict[str, float]:
        """Each Hopper kernel's floor summed over its launches, seconds:
        the scores' from their products, the others' from their bounds."""
        out: Dict[str, float] = {}
        for op in self.matmuls:
            if op.kernel:
                out[op.kernel] = out.get(op.kernel, 0.0) + op.t_floor
        for op in self.kernels:
            out[op.name] = out.get(op.name, 0.0) + op.t_floor
        return out

    def report(self) -> str:
        lines = [
            f"{'kind':<6} {'M':>9} {'K':>5} {'N':>5} "
            f"{'GFLOP':>8} {'attn TF/s':>9} {'floor us':>9}"
        ]
        for op in sorted(self.matmuls, key=lambda o: -o.t_floor)[:20]:
            lines.append(
                f"{op.kind:<6} {op.m:>9} {op.k:>5} {op.n:>5} "
                f"{op.flops / 1e9:>8.2f} {op.attainable_tflops:>9.0f} "
                f"{op.t_floor * 1e6:>9.1f}"
            )
        for name, t in sorted(self.kernel_floors().items()):
            lines.append(f"kernel {name}: floor {t * 1e3:.3f} ms")
        lines.append(
            f"matmul floor {self.t_matmul_floor * 1e3:.3f} ms + kernel "
            f"floor {self.t_kernel_floor * 1e3:.3f} ms + unfused eager "
            f"bytes floor {self.t_other_floor * 1e3:.3f} ms "
            f"({self.other_bytes / 1e9:.2f} GB @ "
            f"{H100_HBM_BW / 1e9:,.0f} GB/s) = attainable "
            f"{self.attainable_s * 1e3:.3f} ms"
        )
        return "\n".join(lines)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _bits(t: torch.Tensor) -> int:
    return t.element_size() * 8


def scores_op(q: torch.Tensor, k: torch.Tensor, num_heads: int) -> MatmulOp:
    """The max-pool attention scores of q [B, N, C] and k [B, M, C] as the
    JAX einsum's product (M = B*h*N, K = C/h, N = M keys), with the bytes
    the kernel moves."""
    b, n, c = q.shape
    m = k.shape[1]
    moved = (_nbytes(q) + _nbytes(k)) + b * n * 4
    return MatmulOp("dot", b * num_heads * n, c // num_heads, m, moved,
                    _bits(q), kernel=_ATTENTION)


def bicubic_op(x: torch.Tensor) -> KernelOp:
    """One launch of the bicubic x2 kernel on x [B, H, W, C]."""
    return KernelOp("upsample_bicubic_x2",
                    BICUBIC_BYTES_PER_INPUT_BYTE * _nbytes(x),
                    BICUBIC_OPS_PER_INPUT * x.numel())


def gelu_op(x: torch.Tensor) -> KernelOp:
    """One launch of the bf16 GELU kernel on x (read once, written once)."""
    return KernelOp("gelu_bf16", 2 * _nbytes(x),
                    GELU_OPS_PER_ELEMENT * x.numel())


def _record_conv(x, wt, bias, groups: int, out: torch.Tensor) -> MatmulOp:
    """NCHW x [B, Cin, ...] and OIHW weights; M, K, N as the JAX model's
    conv_general_dilated (a transposed conv's positions are its
    output's)."""
    b, cin = x.shape[0], x.shape[1]
    cout = out.shape[1]
    taps = math.prod(wt.shape[2:])
    m = b * math.prod(out.shape[2:])
    moved = _nbytes(x) + _nbytes(wt) + _nbytes(out) + (
        0 if bias is None else _nbytes(bias))
    if groups > 1:
        return MatmulOp("dwconv", m, taps * (cin // groups), cout // groups,
                        moved, _bits(x), bw_only=True)
    return MatmulOp("conv", m, taps * cin, cout, moved, _bits(x))


def _record_dot(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                extra: Optional[torch.Tensor] = None) -> MatmulOp:
    """[..., M, K] x [..., K, N]: the batch dimensions multiply M."""
    kk = a.shape[-1]
    m = a.numel() // kk
    n = b.shape[-1]
    moved = _nbytes(a) + _nbytes(b) + _nbytes(out) + (
        0 if extra is None else _nbytes(extra))
    return MatmulOp("dot", m, kk, n, moved, _bits(a))


# operators that move no bytes: views that the schema does not mark as
# such, and allocations that leave their memory as it is
_NO_BYTES = {
    "aten::_unsafe_view", "aten::empty", "aten::empty_like",
    "aten::empty_strided", "aten::new_empty", "aten::new_empty_strided",
    "aten::lift_fresh", "aten::_local_scalar_dense",
}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _tensors(item)
    elif isinstance(tree, dict):
        for item in tree.values():
            yield from _tensors(item)


class _Recorder(TorchDispatchMode):
    def __init__(self, r: Roofline):
        super().__init__()
        self.r = r

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        r = self.r
        name = func._schema.name
        if name == "aten::convolution":
            r.matmuls.append(_record_conv(args[0], args[1], args[2],
                                          int(args[8]), out))
        elif name in ("aten::mm", "aten::bmm"):
            r.matmuls.append(_record_dot(args[0], args[1], out))
        elif name == "aten::addmm":
            r.matmuls.append(_record_dot(args[1], args[2], out, args[0]))
        elif name == "aten::linear":
            x, wt = args[0], args[1]
            bias = args[2] if len(args) > 2 else kwargs.get("bias")
            r.matmuls.append(_record_dot(x, wt.t(), out, bias))
        elif name.startswith("camradepth::" + _ATTENTION) and (
                not name.endswith("_bwd")):
            r.matmuls.append(scores_op(args[0], args[1], int(args[2])))
        elif name == "camradepth::upsample_bicubic_x2":
            r.kernels.append(bicubic_op(args[0]))
        elif name == "camradepth::gelu_bf16":
            r.kernels.append(gelu_op(args[0]))
        elif not func.is_view and name not in _NO_BYTES:
            r.other_bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            r.other_bytes += sum(_nbytes(t) for t in _tensors(out))


def analyze(fn: Callable, *args) -> Roofline:
    """The roofline of ``fn(*args)``, run once without gradients on
    whatever device its tensors lie on: ``meta`` tensors (see
    :func:`forward_roofline`) record it with no weights and no card."""
    r = Roofline()
    with torch.no_grad(), _Recorder(r):
        fn(*args)
    return r


@functools.lru_cache(maxsize=8)
def forward_roofline(model_cfg, batch: int) -> Roofline:
    """The roofline of one inference forward of a CamRaDepth of
    ``model_cfg`` at ``batch`` frames of its image size, recorded on the
    ``meta`` device (a few seconds of host time at ``base``'s depth, so
    each (config, batch) is recorded once a process; do not change the
    result)."""
    from camradepth_tpu_torch.models.camradepth import create_model

    model = create_model(model_cfg, device="meta")
    h, w = model_cfg.img_size
    x = torch.empty((batch, h, w, model_cfg.input_channels),
                    dtype=torch.float32, device="meta")
    return analyze(model, x)
