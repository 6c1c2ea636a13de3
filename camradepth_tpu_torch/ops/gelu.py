"""GELU rounded as the JAX package rounds it.

Counterpart of ``camradepth_tpu/models/layers.py:33-41`` ``gelu_for_dtype``:
the exact erf form in fp32 and ``nn.gelu(x, approximate=True)`` in bf16.
On bf16 JAX evaluates the tanh form as eight bf16 operations, each rounded
to bf16, with its constants rounded to bf16 first:

    x**3, * 0.044677734375, + x, * 0.796875, tanh, + 1, * 0.5, * x

torch's ``F.gelu(approximate="tanh")`` evaluates in fp32 and rounds once,
which differs on about 4 % of bf16 inputs. :func:`gelu_bf16_reference`
repeats JAX's eight operations on bf16 tensors (a Python scalar times a
bf16 tensor multiplies in fp32 and rounds once, so the constants are the
bf16-exact values above); it equals JAX's result bit for bit on every
input above XLA's subnormal flush.

:func:`gelu_bf16` is the kernel's wrapper: on a CUDA tensor it launches the
elementwise kernel ``csrc/gelu_bf16.cu`` (one launch, where the plain
version would be eight), on a CPU tensor it runs the plain version, both
through the operator ``torch.ops.camradepth.gelu_bf16`` (``gelu_op``;
its CUDA implementation launches and counts), which an exported graph
(``interop/export.py``) keeps. When
gradients must flow it goes through :class:`_GeluBf16`, whose backward is
the VJP as JAX evaluates it on bf16 (21 operations, each rounded; see
:func:`gelu_bf16_backward_reference`), not torch's autograd of the eight
forward operations, which rounds at other places: on the card the kernel's
second entry point ``gelu_bf16_bwd`` (the operator
``torch.ops.camradepth.gelu_bf16_bwd``, ``gelu_bwd_op``), on the CPU the
plain version. Under ``torch.func.vmap`` both operators run once on every
trial's elements (their vmap rules, ``_build.register_vmap``), and
:class:`_GeluBf16` takes its vmap rule from them. Both
kernels read what depends on x through tanh from tables of the inputs in
``TABLE_FIELDS``, with shortcuts outside them (tests/test_torch_gelu.py
checks both on every bf16 input). Each kernel's first launch on a card
fills its table there and waits for it (a stream synchronisation): make it
outside a CUDA graph capture.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from camradepth_tpu_torch.ops import _build

# sqrt(2/pi) and 0.044715 rounded to bf16, as jax.nn.gelu's bf16 jaxpr has
# them; 0.5 and 1.0 are exact
BF16_SQRT_2_OVER_PI = 0.796875
BF16_KAPPA = 0.044677734375
# the exponent fields [lo, hi) of the bf16 inputs whose GELU and VJP term i
# the kernels read from tables (csrc/gelu_bf16.cuh kGeluLo, kGeluHi)
TABLE_FIELDS = (118, 129)


def gelu_bf16_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the eight bf16 operations of jax.nn.gelu's tanh form,
    each rounded to bf16."""
    cube = x * x * x
    inner = (x + cube * BF16_KAPPA) * BF16_SQRT_2_OVER_PI
    return x * ((torch.tanh(inner) + 1.0) * 0.5)


def gelu_bf16_tanh_term(x: torch.Tensor) -> torch.Tensor:
    """The VJP's term i = tanh(0.796875 * (x + 0.044677734375 * x*x*x)),
    each operation rounded to bf16: the one x-only term that the kernel
    reads from its table (exponent fields ``TABLE_FIELDS``)."""
    d = x * x
    c = d * x
    f = c * BF16_KAPPA
    return torch.tanh((x + f) * BF16_SQRT_2_OVER_PI)


def gelu_bf16_backward_reference(x: torch.Tensor,
                                 g: torch.Tensor) -> torch.Tensor:
    """Plain version of the VJP of :func:`gelu_bf16_reference` for the
    cotangent ``g``: the operations of the jaxpr of ``jax.vjp(partial(
    jax.nn.gelu, approximate=True), x)[1]`` on bf16, in its order, each
    rounded to bf16."""
    d = x * x
    e = d * 3.0
    i = gelu_bf16_tanh_term(x)
    j = 1.0 - i
    half = (i + 1.0) * 0.5
    n = g * half
    p = ((x * g) * 0.5) * j
    r = p + p * i
    s = r * BF16_SQRT_2_OVER_PI
    return (n + s) + (s * BF16_KAPPA) * e


def _check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"x must lie on the CPU or a CUDA device, got "
                         f"{x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the GELU kernels take bf16, got {x.dtype}")


def _gelu_op_cuda(x):
    _check_cuda(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    _build.launch("gelu_bf16", "gelu_bf16", x.device, x.data_ptr(),
                  out.data_ptr(), x.numel())
    gelu_bf16.launches += 1
    return out


# the forward outside autograd as an operator of its own: the plain
# version on the CPU, the kernel on a CUDA device (where it counts the
# launch)
gelu_op = _build.register_op("gelu_bf16", "(Tensor x) -> Tensor",
                             cpu=gelu_bf16_reference, cuda=_gelu_op_cuda,
                             fake=torch.empty_like)


def _gelu_vmap(info, in_dims, x):
    # elementwise: one launch over every trial's elements
    return gelu_op(x), in_dims[0]


_build.register_vmap("gelu_bf16", _gelu_vmap)


def _forward(x: torch.Tensor) -> torch.Tensor:
    if x.device.type not in _build.NO_KERNEL:
        _check_cuda(x)
    return gelu_op(x)


def _gelu_bwd_op_cuda(x, g):
    _check_cuda(x)
    x = x.contiguous()
    g = g.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    _build.launch("gelu_bf16", "gelu_bf16_bwd", x.device, x.data_ptr(),
                  g.data_ptr(), out.data_ptr(), x.numel())
    gelu_bf16_backward.launches += 1
    return out


# the VJP as an operator of its own, as the forward
gelu_bwd_op = _build.register_op(
    "gelu_bf16_bwd", "(Tensor x, Tensor g) -> Tensor",
    cpu=gelu_bf16_backward_reference, cuda=_gelu_bwd_op_cuda,
    fake=lambda x, g: torch.empty_like(x))


def _gelu_bwd_vmap(info, in_dims, x, g):
    x, g = _build.batch_first(info, in_dims, x, g)
    return gelu_bwd_op(x, g), 0


_build.register_vmap("gelu_bf16_bwd", _gelu_bwd_vmap)


def gelu_bf16_backward(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The bf16 GELU's VJP at ``x`` for the cotangent ``g`` (bf16, the
    shape of x): the kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if x.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise TypeError(f"gelu_bf16_backward takes bf16, got {x.dtype} and "
                        f"{g.dtype}")
    if x.device.type not in _build.NO_KERNEL:
        _check_cuda(x)
    return gelu_bwd_op(x, g)


gelu_bf16_backward.launches = 0


class _GeluBf16(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _forward(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return gelu_bf16_backward(x, g)


def gelu_bf16(x: torch.Tensor) -> torch.Tensor:
    """JAX's bf16 tanh-form GELU of a bf16 tensor of any shape;
    differentiable with JAX's bf16 VJP."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"gelu_bf16 takes bf16, got {x.dtype}")
    if _build.needs_grad(x):
        return _GeluBf16.apply(x)
    return _forward(x)


gelu_bf16.launches = 0


def gelu_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain GELU for the dtype: exact erf in fp32, JAX's bf16 tanh form in
    bf16."""
    if x.dtype == torch.bfloat16:
        return gelu_bf16_reference(x)
    return F.gelu(x)


def gelu_for_dtype(x: torch.Tensor) -> torch.Tensor:
    """GELU for the dtype, as the JAX package: exact erf in fp32 (torch's
    nn.GELU), the bf16 tanh form in bf16 through :func:`gelu_bf16`."""
    if x.dtype == torch.bfloat16:
        return gelu_bf16(x)
    return F.gelu(x)
