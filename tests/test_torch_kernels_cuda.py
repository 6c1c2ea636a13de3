"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Skipped without CUDA (a CUDA kernel has no CPU or interpret mode).

This file imports only torch and the port, so it runs on a machine without
JAX; there, skip the JAX-based tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the attention kernel sums the d products in another order than
the plain einsum (1e-5 relative, fp32 accumulation in both dtypes; in bf16
on the tensor cores, whose products are exact in fp32); the bicubic and
the bf16 GELU kernels round every operation as their plain versions do, so
they must agree bit for bit, and so must their backward kernels. The
attention backward's dq is one product per element (bit for bit); its dk
sums the products in fp32 in another order than the plain scatter-add
(rtol 1e-5, atol 1e-5 in fp32; in bf16 the one rounding of those sums may
then land one bf16 ulp apart, so 1 bf16 ulp). The argmax equals the plain one except where the two largest
dots of a row lie within the sums' roundoff of each other (a near tie,
gap below 1e-4 * (1 + |max|)); there the kernel's key must be one of the
tied ones. The fused conv sums its fp32 products in another
order than cuDNN's fp32 conv before the one rounding of its raw output: at
most 1 bf16 ulp in bf16 (for outputs above 2**-7 of their RMS; see
_bf16_ulps), and rtol 1e-4, atol 2e-5 in fp32 (the JAX
package's own limits, tests/test_conv_fused.py:38-40); its fp32 channel
sums run over H*W terms, so rtol 1e-4 and atol 1e-3 * sqrt(H*W).
"""

import dataclasses

import numpy as np
import pytest
import torch

from camradepth_tpu_torch.ops.attention import (
    maxpool_attention_scores,
    maxpool_attention_scores_backward,
    maxpool_attention_scores_backward_reference,
    maxpool_attention_scores_reference,
    maxpool_attention_scores_with_argmax,
)
from camradepth_tpu_torch.ops.conv_fused import (
    Source,
    conv3x3_fused,
    conv3x3_reference,
    gn_affine_from_stats,
)
from camradepth_tpu_torch.ops.gelu import (
    gelu_bf16,
    gelu_bf16_backward,
    gelu_bf16_backward_reference,
    gelu_bf16_reference,
)
from camradepth_tpu_torch.ops.resize import (
    launch_backward as launch_upsample_backward,
    upsample_backward_plan,
    upsample_bicubic_x2,
    upsample_bicubic_x2_backward,
    upsample_bicubic_x2_backward_reference,
    upsample_bicubic_x2_reference,
)

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _randn(shape, seed, dtype, device):
    g = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(g).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,m,c,heads", [
    (2, 20800, 325, 64, 1), (2, 5200, 325, 128, 2), (2, 1300, 325, 160, 4),
    (2, 325, 325, 256, 8), (3, 1001, 77, 120, 3), (1, 5, 1, 16, 4),
    # the tensor-core tiles' edges: d = 8 and 40, M off the 16-key tile
    # and M = 1, N below one 16-token tile
    (2, 9, 33, 8, 1), (1, 37, 1, 40, 1), (2, 300, 17, 80, 2),
])
def test_attention_kernel_matches_plain(cuda, dtype, b, n, m, c, heads):
    q = _randn((b, n, c), 0, dtype, cuda)
    k = _randn((b, m, c), 1, dtype, cuda)
    scale = (c // heads) ** -0.5
    before = maxpool_attention_scores.launches
    got = maxpool_attention_scores(q, k, heads, scale)
    torch.cuda.synchronize()
    assert maxpool_attention_scores.launches == before + 1
    want = maxpool_attention_scores_reference(q, k, heads, scale)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_attention_kernel_rejects_wide_heads(cuda):
    q = torch.zeros(1, 4, 128, device=cuda)
    with pytest.raises(ValueError, match="head dims <= 64"):
        maxpool_attention_scores(q, q, 1, 1.0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,offset", [
    # the five decoder inputs of base at 416x800
    ((2, 13, 25, 256), 0), ((2, 26, 50, 128), 0), ((2, 52, 100, 128), 0),
    ((2, 104, 200, 129), 0), ((1, 208, 400, 129), 0),
    # C = 1, 8, 129, 257, 513; W*C*es off 16 bytes (C = 3, 129, 257, 513)
    ((2, 5, 7, 1), 0), ((1, 6, 11, 8), 0), ((2, 7, 9, 129), 0),
    ((1, 4, 6, 257), 0), ((1, 3, 5, 513), 0), ((3, 7, 9, 3), 0),
    # H = 1, W = 1, both
    ((2, 1, 37, 16), 0), ((2, 23, 1, 24), 0), ((1, 1, 1, 5), 0),
    # W wider than one block's span, with a ragged last span; B = 3
    ((1, 9, 61, 129), 0), ((1, 3, 1001, 8), 0), ((3, 10, 33, 64), 0),
    # contiguous views one element into their storage: every row off the
    # 16-byte grid, or all rows on it but at another phase
    ((2, 7, 9, 129), 1), ((2, 6, 10, 64), 1), ((1, 5, 8, 16), 1),
])
def test_upsample_kernel_matches_plain_bitwise(cuda, dtype, shape, offset):
    n = int(np.prod(shape))
    x = _randn((n + offset,), 2, dtype, cuda)[offset:].view(shape)
    assert x.is_contiguous() and x.storage_offset() == offset
    before = upsample_bicubic_x2.launches
    got = upsample_bicubic_x2(x)
    torch.cuda.synchronize()
    assert upsample_bicubic_x2.launches == before + 1
    torch.testing.assert_close(got, upsample_bicubic_x2_reference(x),
                               rtol=0, atol=0)


def _bf16_ulps(got, want):
    """Largest |got - want| in bf16 ulps of the larger magnitude, taken at
    no less than 2**-7 of the output's RMS: below that the fp32 sums'
    order differences (up to ~1.5e-5 of the RMS, seen on the H100) exceed
    a bf16 ulp of the output."""
    g, w = got.float(), want.float()
    floor = max(2.0**-7 * w.square().mean().sqrt().item(),
                torch.finfo(torch.bfloat16).tiny)
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(floor)
    ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(
        torch.log2(mag)))
    return ((g - w).abs() / ulp).max().item()


def _conv_chain(b, h, w, k0, widths, dtype, device, seed):
    """The three chained convs of a ShortResBlock: layer i reads the input
    and the raw outputs of the layers before it, each through its GroupNorm
    affine (from the previous launch's statistics) and GELU."""
    rng = np.random.default_rng(seed)
    x = _randn((b, h, w, k0), seed, dtype, device)
    sources = [Source(x)]
    steps = []
    for n in widths:
        k = sum(s.x.shape[-1] for s in sources)
        wt = torch.from_numpy(rng.standard_normal((3, 3, k, n)).astype(
            np.float32) / np.float32(np.sqrt(9 * k))).to(device)
        steps.append((list(sources), wt))
        raw, s, q = conv3x3_reference(sources, wt)
        gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(n).astype(
            np.float32)).to(device)
        beta = torch.from_numpy(0.1 * rng.standard_normal(n).astype(
            np.float32)).to(device)
        groups = n // 16 if n % 16 == 0 else 1
        sc, sh = gn_affine_from_stats(s, q, h * w, gamma, beta, groups)
        sources.append(Source(raw, sc, sh, True))
    return steps


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,k0,widths", [
    (2, 26, 50, 416, (96, 64, 128)),     # base stage 1
    (1, 104, 200, 129, (96, 64, 128)),   # base stage 4, K0 = 129
    (2, 17, 23, 37, (13, 5, 70)),        # ragged: odd H, W; K, N off tiles
    (1, 1, 1, 3, (1,)),
    # a 1-row image, K off the 32-channel chunk, N = 8 and 72
    (1, 1, 29, 40, (8, 72)),
    # H, W off 8 and 16; a 13-channel source, so the next one starts
    # inside a 16-byte vector of the concat; N = 128 in one block
    (2, 12, 21, 13, (128, 8)),
])
def test_conv3x3_fused_kernel_matches_plain(cuda, dtype, b, h, w, k0,
                                            widths):
    torch.backends.cudnn.allow_tf32 = False
    for sources, wt in _conv_chain(b, h, w, k0, widths, dtype, cuda, 3):
        before = conv3x3_fused.launches
        got = conv3x3_fused(sources, wt)
        torch.cuda.synchronize()
        assert conv3x3_fused.launches == before + 1
        want = conv3x3_reference(sources, wt)
        assert got[0].shape == want[0].shape and got[0].dtype == dtype
        if dtype == torch.bfloat16:
            assert _bf16_ulps(got[0], want[0]) <= 1.0
        else:
            torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=2e-5)
        atol = 1e-3 * (h * w) ** 0.5
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=atol)
        torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=atol)


def test_conv3x3_fused_statistics_are_deterministic(cuda):
    (sources, wt), = _conv_chain(2, 52, 100, 192, (96,), torch.bfloat16,
                                 cuda, 4)
    first = conv3x3_fused(sources, wt)
    again = conv3x3_fused(sources, wt)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_conv3x3_fused_reads_padded_sources(cuda):
    x = _randn((1, 9, 11, 8), 5, torch.float32, cuda)
    padded = torch.cat([x, _randn((1, 9, 11, 4), 6, torch.float32, cuda)],
                       dim=-1)
    wt = _randn((3, 3, 8, 6), 7, torch.float32, cuda)
    got = conv3x3_fused([Source(padded, valid=8)], wt)
    want = conv3x3_reference([Source(x)], wt)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv3x3_fused_reads_unaligned_views(cuda, dtype):
    """Contiguous views that start one element into their storage cannot
    be read as 16-byte vectors: the kernel takes its scalar loads there."""
    b, h, w, c, n = 2, 9, 13, 16, 24
    flat = _randn((b * h * w * c + 1,), 9, dtype, cuda)
    x = flat[1:].view(b, h, w, c)
    sc = _randn((b * c + 1,), 10, torch.float32, cuda)[1:].view(b, c)
    sh = _randn((b * c + 1,), 11, torch.float32, cuda)[1:].view(b, c)
    wt = _randn((3 * 3 * c * n + 1,), 12, dtype, cuda)[1:].view(3, 3, c, n)
    srcs = [Source(x, sc.to(dtype), sh.to(dtype), True)]
    got = conv3x3_fused(srcs, wt)
    want = conv3x3_reference(srcs, wt)
    if dtype == torch.bfloat16:
        assert _bf16_ulps(got[0], want[0]) <= 1.0
    else:
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("call", ["conv"])
def test_kernels_refuse_inputs_that_need_gradients(cuda, call):
    """The fused conv is inference-only (as in the JAX package)."""
    x = _randn((1, 4, 6, 8), 8, torch.float32, cuda).requires_grad_()
    fns = {
        "conv": lambda: conv3x3_fused(
            [Source(x)], torch.zeros(3, 3, 8, 4, device=cuda)),
    }
    with pytest.raises(RuntimeError, match="no backward"):
        fns[call]()
    with torch.no_grad():
        fns[call]()


@pytest.mark.parametrize("call", ["attention", "upsample", "gelu"])
def test_kernels_pass_gradients_that_match_the_plain_version(cuda, call):
    """A CUDA input that needs a gradient runs the forward and backward
    kernels, and the gradient equals the plain version's autograd (dense
    max for the attention scores; bit for bit for the bicubic and GELU)."""
    dtype = torch.bfloat16 if call == "gelu" else torch.float32
    x = _randn((1, 4, 6, 8), 8, dtype, cuda).requires_grad_()
    y = _randn((1, 4, 6, 8), 9, dtype, cuda).requires_grad_()
    fns = {
        "attention": (lambda f, a, b: f(a.reshape(1, 24, 8),
                                        b.reshape(1, 24, 8), 2, 0.5),
                      maxpool_attention_scores,
                      maxpool_attention_scores_reference),
        "upsample": (lambda f, a, b: f(a), upsample_bicubic_x2,
                     upsample_bicubic_x2_reference),
        "gelu": (lambda f, a, b: f(a), gelu_bf16, None),
    }
    call_fn, kernel, plain = fns[call]
    counters = {"attention": maxpool_attention_scores_backward,
                "upsample": upsample_bicubic_x2_backward,
                "gelu": gelu_bf16_backward}
    before = counters[call].launches
    out = call_fn(kernel, x, y)
    g = _randn(tuple(out.shape), 10, out.dtype, cuda)
    got = torch.autograd.grad(out, [x, y], g, allow_unused=True)
    torch.cuda.synchronize()
    assert counters[call].launches == before + 1
    if call == "gelu":
        want = gelu_bf16_backward_reference(x.detach(), g)
        assert torch.equal(got[0].view(torch.int16), want.view(torch.int16))
        return
    x2 = x.detach().clone().requires_grad_()
    y2 = y.detach().clone().requires_grad_()
    want = torch.autograd.grad(call_fn(plain, x2, y2), [x2, y2], g,
                               allow_unused=True)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _near_tie_ok(q, k, heads, got_amax):
    """The kernel's argmax against the plain fp32 dots: equal, or (where
    the two largest dots of a row are within 1e-4 * (1 + |max|)) one of
    the tied keys. Returns the number of near-tied rows."""
    b, n, c = q.shape
    d = c // heads
    dots = torch.einsum("bnhd,bmhd->bhnm", q.float().reshape(b, n, heads, d),
                        k.float().reshape(b, -1, heads, d))
    top2 = dots.topk(min(2, dots.shape[-1]), dim=-1).values
    bound = 1e-4 * (1 + top2[..., 0].abs())
    tie = (top2[..., 0] - top2[..., -1] <= bound) & (dots.shape[-1] > 1)
    want = dots.argmax(dim=-1).to(torch.int32)
    assert bool(((got_amax == want) | tie).all())
    at = torch.gather(dots, -1, got_amax.long()[..., None])[..., 0]
    assert bool((top2[..., 0] - at <= bound).all())
    return int(tie.sum())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,m,c,heads,offset", [
    # the four stage shapes of a base 416x800 training microbatch
    (2, 20800, 325, 64, 1, 0), (2, 5200, 325, 128, 2, 0),
    (2, 1300, 325, 160, 4, 0), (2, 325, 325, 256, 8, 0),
    # d = 8 and 40, M off the key tile and M = 1, N below one token tile,
    # B = 3
    (2, 9, 33, 8, 1, 0), (1, 37, 1, 40, 1, 0), (3, 1001, 77, 120, 3, 0),
    # element staging and gathers: d = 6 is no multiple of a 16-byte
    # vector; q and k one element into their storage, off the 16-byte grid
    (1, 37, 5, 12, 2, 0), (3, 1001, 77, 120, 3, 1),
])
def test_attention_backward_kernel_matches_plain(cuda, dtype, b, n, m, c,
                                                 heads, offset):
    torch.backends.cuda.matmul.allow_tf32 = False

    def view(shape, seed):
        flat = _randn((int(np.prod(shape)) + offset,), seed, dtype, cuda)
        return flat[offset:].view(shape)

    q, k = view((b, n, c), 20), view((b, m, c), 21)
    if offset:
        assert q.data_ptr() % 16 and k.data_ptr() % 16
    g = _randn((b, n), 22, torch.float32, cuda)
    scale = (c // heads) ** -0.5
    s, amax = maxpool_attention_scores_with_argmax(q, k, heads, scale)
    # the argmax launch gives the inference launch's scores bit for bit
    assert torch.equal(s, maxpool_attention_scores(q, k, heads, scale))
    _near_tie_ok(q, k, heads, amax)
    _hold_backward_to_plain(q, k, amax, g, heads, scale)


def _hold_backward_to_plain(q, k, amax, g, heads, scale):
    """One launch of the backward kernel against the plain version: dq bit
    for bit, dk within 1 bf16 ulp or rtol/atol 1e-5, and a second launch
    bit for bit with the first."""
    before = maxpool_attention_scores_backward.launches
    dq, dk = maxpool_attention_scores_backward(q, k, amax, g, heads, scale)
    torch.cuda.synchronize()
    assert maxpool_attention_scores_backward.launches == before + 1
    want_dq, want_dk = maxpool_attention_scores_backward_reference(
        q, k, amax, g, heads, scale)
    assert dq.dtype == q.dtype and dk.dtype == q.dtype
    assert torch.equal(dq, want_dq)
    if q.dtype == torch.bfloat16:
        assert _bf16_ulps(dk, want_dk) <= 1.0
    else:
        torch.testing.assert_close(dk, want_dk, rtol=1e-5, atol=1e-5)
    # deterministic: a second launch gives the same bits
    dq2, dk2 = maxpool_attention_scores_backward(q, k, amax, g, heads, scale)
    assert torch.equal(dk, dk2) and torch.equal(dq, dq2)


ONE_KEY = 123


def _one_key_inputs(b, n, m, c, dtype, device):
    """q, k and g for which every token of every head takes key ONE_KEY:
    q's entries are multiples of 1/8 in [0, 4), k's row ONE_KEY is 4 in
    every channel (its dot exceeds 4 * sum(q) >= the others' by far) and
    the other rows N(0, 1), g integers in [-8, 8]. At d = 64 the scale is
    1/8, so each product gs * q is a multiple of 2**-6 below 4 in magnitude
    and every partial sum of up to 20,800 of them is exact in fp32: the
    plain scatter-add and the kernel add the same terms in other orders,
    and on random data those orders alone differ by ~6e-5 over 20,800
    terms, past rtol/atol 1e-5 wherever the sum is small."""
    rng = np.random.default_rng(30)
    q = np.floor(np.abs(rng.standard_normal((b, n, c))) * 8).clip(0, 31) / 8
    k = rng.standard_normal((b, m, c))
    k[:, ONE_KEY] = 4.0
    g = rng.integers(-8, 9, (b, n))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device, dt)
                 for a, dt in ((q, dtype), (k, dtype), (g, torch.float32)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,m,c,heads", [
    # stages 1 and 2 of a base 416x800 training microbatch
    (2, 20800, 325, 64, 1), (2, 5200, 325, 128, 2),
])
@pytest.mark.parametrize("skew", ["one_key", "every_key"])
def test_attention_backward_kernel_under_skewed_argmax(cuda, dtype, b, n, m,
                                                       c, heads, skew):
    """one_key: every token's argmax is one key (k with one dominant row,
    the forward's argmax launch), so each chunk of the kernel hits one key
    and one dk row sums all N tokens; every_key: the argmax cycles through
    all M keys (97 is prime to 325), so each chunk hits as many keys as it
    has tokens. Held to the limits of the other shapes."""
    scale = (c // heads) ** -0.5
    if skew == "one_key":
        q, k, g = _one_key_inputs(b, n, m, c, dtype, cuda)
        amax = maxpool_attention_scores_with_argmax(q, k, heads, scale)[1]
        assert bool((amax == ONE_KEY).all())
    else:
        q = _randn((b, n, c), 25, dtype, cuda)
        k = _randn((b, m, c), 26, dtype, cuda)
        g = _randn((b, n), 27, torch.float32, cuda)
        tok = torch.arange(n, device=cuda)
        amax = torch.stack([
            torch.stack([(97 * tok + 13 * h + 5 * i) % m
                         for h in range(heads)]) for i in range(b)]).to(
            torch.int32)
        for row in amax.reshape(-1, n):
            assert bool((torch.bincount(row, minlength=m) > 0).all())
    _hold_backward_to_plain(q, k, amax, g, heads, scale)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    # the five decoder inputs of base at 416x800, batch 2
    (2, 13, 25, 256), (2, 26, 50, 128), (2, 52, 100, 128), (2, 104, 200, 129),
    (2, 208, 400, 129),
    # C = 1, 3, 129; H = 1, W = 1, both, H = W = 2; B = 3
    (2, 5, 7, 1), (3, 7, 9, 3), (1, 1, 37, 16), (2, 23, 1, 24),
    (1, 1, 1, 5), (1, 2, 2, 129),
    # both edges' folds on one row or column (the JAX VJP tests' shapes)
    (1, 1, 3, 2), (2, 2, 1, 4), (1, 5, 7, 129),
])
def test_upsample_backward_kernel_matches_plain_bitwise(cuda, dtype, shape):
    b, h, w, c = shape
    gy = _randn((b, 2 * h, 2 * w, c), 23, dtype, cuda)
    before = upsample_bicubic_x2_backward.launches
    got = upsample_bicubic_x2_backward(gy)
    torch.cuda.synchronize()
    assert upsample_bicubic_x2_backward.launches == before + 1
    want = upsample_bicubic_x2_backward_reference(gy)
    assert got.shape == (b, h, w, c) and got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,offset", [
    # many runs of 4 columns per row (run boundaries mid-row, off the
    # 16-byte grid at C = 129), a ragged last run; two channel tiles
    ((2, 37, 50, 129), 0), ((1, 3, 1001, 8), 0), ((1, 5, 9, 300), 0),
    # C = 3, and both H folds in one strip
    ((1, 9, 5, 3), 0), ((1, 1, 3, 2), 0),
    # gy one element into its storage: rows off the 16-byte grid, or all on
    # it at another phase
    ((2, 37, 50, 129), 1), ((1, 6, 20, 16), 1),
])
@pytest.mark.parametrize("rows", [None, 1, 3, 32])
def test_upsample_backward_kernel_strips_and_spans(cuda, dtype, shape, offset,
                                                   rows):
    """The adjoint with the gx rows per block set directly (None: the
    plan's): strip boundaries fall mid-image (H = 37 is no multiple of 3 or
    32), every strip streams its 6-row halo, the first and last strips
    fold the pad rows, and run boundaries fall mid-row; bit for bit with
    the plain version."""
    b, h, w, c = shape
    n = b * 2 * h * 2 * w * c
    gy = _randn((n + offset,), 24, dtype, cuda)[offset:].view(
        b, 2 * h, 2 * w, c)
    if rows is None:
        got = upsample_bicubic_x2_backward(gy)
    else:
        got = torch.empty((b, h, w, c), dtype=dtype, device=cuda)
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        launch_upsample_backward(gy, got, upsample_backward_plan(
            b, h, w, c, gy.element_size(), sms, rows))
    torch.cuda.synchronize()
    assert torch.equal(got, upsample_bicubic_x2_backward_reference(gy))


def test_gelu_bf16_backward_kernel_matches_plain_bitwise(cuda):
    """Every bf16 bit pattern of x against a few cotangents, and an
    odd-length view one element into its storage."""
    bits = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32)
    x = bits.to(torch.int16).view(torch.bfloat16).to(cuda)
    for gval in (1.0, -0.3125, 3.5, 1e-3):
        gy = torch.full_like(x, gval)
        for v, gv in ((x, gy), (x[1:-2], gy[1:-2])):
            got = gelu_bf16_backward(v, gv)
            want = gelu_bf16_backward_reference(v, gv)
            same = (got.view(torch.int16) == want.view(torch.int16)) | (
                got.isnan() & want.isnan())
            assert bool(same.all()), gval
    gy = _randn(tuple(x.shape), 24, torch.bfloat16, cuda)
    got = gelu_bf16_backward(x, gy)
    want = gelu_bf16_backward_reference(x, gy)
    same = (got.view(torch.int16) == want.view(torch.int16)) | (
        got.isnan() & want.isnan())
    assert bool(same.all())


def test_gelu_bf16_kernel_matches_plain_bitwise(cuda):
    """Every bf16 bit pattern, plus an odd-length view that starts one
    element into its storage (no 16-byte vectors there)."""
    bits = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32)
    x = bits.to(torch.int16).view(torch.bfloat16).to(cuda)
    for v in (x, x[1:-2]):
        before = gelu_bf16.launches
        got = gelu_bf16(v)
        torch.cuda.synchronize()
        assert gelu_bf16.launches == before + 1
        want = gelu_bf16_reference(v)
        same = (got.view(torch.int16) == want.view(torch.int16)) | (
            got.isnan() & want.isnan())
        assert bool(same.all())


@pytest.mark.parametrize("option", ["remat_encoder", "remat_decoder",
                                    "remat_decoder_small"])
def test_remat_on_the_card_gives_the_gradients_of_no_remat(cuda, option):
    """torch.utils.checkpoint replays the global RNG, not a CUDA
    torch.Generator: the port rewinds the dropout generators for the
    recompute, so the gradients with remat equal those without, bit for
    bit, in bf16 with dropout on (cuDNN held deterministic)."""
    import dataclasses

    from camradepth_tpu_torch.config import tiny_test_config
    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.train.diffgrad import DiffGradNorm
    from camradepth_tpu_torch.train.step import train_step

    torch.backends.cudnn.deterministic = True
    base = tiny_test_config()
    base = base.replace(model=dataclasses.replace(
        base.model, img_size=(64, 128), compute_dtype="bfloat16",
        drop_path_rate=0.1, dropout_rate=0.2))
    micro = {"features": _randn((2, 64, 128, 7), 30, torch.float32, cuda),
             "gt_depth": _randn((2, 64, 128), 31, torch.float32,
                                cuda).abs().clamp(max=1.0)}

    def grads(cfg):
        model = create_model(cfg.model, device=cuda, seed=5, train=True)
        opt = DiffGradNorm(model.parameters(), lr=0.0)
        gen = torch.Generator(device=cuda).manual_seed(7)
        m = train_step(cfg, model, opt, [micro], [gen], 0.0)
        return float(m["loss"]), {k: p.grad.clone()
                                  for k, p in model.named_parameters()}

    loss0, g0 = grads(base)
    loss1, g1 = grads(base.replace(model=dataclasses.replace(
        base.model, **{option: True})))
    assert loss0 == loss1
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def _wire_batch(seed, b=2, h=64, w=128, points=300, gt_points=2000):
    """A wire batch as the encoder writes it: unique pixel indices, then
    padding rows (index 0, value 0); a real point at pixel 0 of frame 0
    holds a -0.0 in one channel."""
    rng = np.random.default_rng(seed)
    out = {"image_u8": rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
           "radar_idx": np.zeros((b, points + 64), np.int32),
           "radar_val": np.zeros((b, points + 64, 4), np.float32),
           "gt_idx": np.zeros((b, gt_points + 256), np.int32),
           "gt_val": np.zeros((b, gt_points + 256), np.float32),
           "seg": rng.integers(0, 256, (b, h, w), dtype=np.uint8)}
    for i in range(b):
        pts = np.sort(rng.choice(h * w, points, replace=False))
        out["radar_idx"][i, :points] = pts
        out["radar_val"][i, :points] = rng.standard_normal((points, 4))
        gts = np.sort(rng.choice(h * w, gt_points, replace=False))
        out["gt_idx"][i, :gt_points] = gts
        out["gt_val"][i, :gt_points] = rng.uniform(0.01, 1.0, gt_points)
    out["radar_idx"][0, 0] = 0
    out["radar_val"][0, 0, 1] = -0.0
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_wire_decode_on_the_card_is_the_cpu_decode(cuda, dtype):
    """decode_wire_micro on the card (index_add_ adds with atomics) gives
    the CPU decode's bits: every real pixel appears once and the padding
    rows add +0.0."""
    from camradepth_tpu_torch.data.wire import decode_wire_micro

    batch = {k: torch.from_numpy(v) for k, v in _wire_batch(40).items()}
    batch["radar_val"] = batch["radar_val"].to(dtype)
    want = decode_wire_micro(batch)
    got = decode_wire_micro({k: v.to(cuda) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k].cpu()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert torch.equal(g.view(torch.int32), v.view(torch.int32)), k


def test_distill_step_on_the_card_matches_the_cpu(cuda):
    """One fp32 distill step (base + tpu_decoder student, parity teacher,
    tiny widths at 128x256, alpha 0.5, temperature 2, microbatches padded
    to 3, TF32 off) on the card and on the CPU from the same weights and
    inputs: loss and grad_norm rtol 1e-3, each gradient relative L2 1e-3,
    as chip_smoke's train-step check on the card."""
    import dataclasses
    import functools

    from camradepth_tpu_torch.config import tiny_test_config
    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.train.diffgrad import DiffGradNorm
    from camradepth_tpu_torch.train.distill import distill_loss
    from camradepth_tpu_torch.train.step import train_step

    cfg = tiny_test_config()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, img_size=(128, 256),
                                  dropout_rate=0.0, tpu_decoder=True),
        train=dataclasses.replace(cfg.train, pad_microbatch_to=3))
    teacher_cfg = dataclasses.replace(cfg.model, tpu_decoder=False)
    teacher_sd = create_model(teacher_cfg, device="cpu", seed=2,
                              train=True).state_dict()
    rng = np.random.default_rng(41)
    micro = {"features": rng.standard_normal((2, 128, 256, 7),
                                             dtype=np.float32),
             "gt_depth": (rng.uniform(0.01, 1.0, (2, 128, 256))
                          * (rng.uniform(size=(2, 128, 256)) < 0.25)
                          ).astype(np.float32)}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    try:
        for dev in (cuda, torch.device("cpu")):
            model = create_model(cfg.model, device=dev, seed=3, train=True)
            teacher = create_model(teacher_cfg, device=dev,
                                   state_dict=teacher_sd)
            loss_fn = functools.partial(distill_loss, teacher=teacher,
                                        alpha=0.5, temperature=2.0)
            m = train_step(cfg, model, DiffGradNorm(model.parameters(),
                                                    lr=1e-4),
                           [{k: torch.from_numpy(v).to(dev)
                             for k, v in micro.items()}], [None], 1e-4,
                           loss_fn=loss_fn)
            results[dev.type] = ({k: float(v) for k, v in m.items()},
                                 {k: p.grad.double().cpu()
                                  for k, p in model.named_parameters()})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    (mc, gc), (mp, gp) = results["cuda"], results["cpu"]
    for k in ("loss", "loss_distill", "loss_gt", "grad_norm"):
        assert abs(mc[k] - mp[k]) <= 1e-3 * abs(mp[k]), (k, mc[k], mp[k])
    for k, g in gp.items():
        rel = ((gc[k] - g).norm() / g.norm().clamp_min(1e-30)).item()
        assert rel <= 1e-3, (k, rel)


@pytest.mark.parametrize("op,dtype", [
    ("scores", torch.float32), ("scores", torch.bfloat16),
    ("bicubic", torch.float32), ("bicubic", torch.bfloat16),
    ("gelu", torch.bfloat16)])
def test_custom_ops_launch_the_kernel(cuda, op, dtype):
    """Each kernel's operator (``torch.ops.camradepth.*``, the form an
    exported artifact calls) on CUDA tensors launches the kernel once,
    equals the plain version (bit for bit for the bicubic and the GELU,
    the attention limits for the scores), and its fake implementation
    gives the kernel's shape, dtype and device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if op == "scores":
        args = (_randn((2, 1300, 160), 61, dtype, cuda),
                _randn((2, 325, 160), 62, dtype, cuda), 4, 40 ** -0.5)
        fn, wrapper = torch.ops.camradepth.maxpool_attention_scores, (
            maxpool_attention_scores)
        want = maxpool_attention_scores_reference(*args)
    elif op == "bicubic":
        args = (_randn((2, 13, 25, 256), 63, dtype, cuda),)
        fn, wrapper = torch.ops.camradepth.upsample_bicubic_x2, (
            upsample_bicubic_x2)
        want = upsample_bicubic_x2_reference(*args)
    else:
        args = (_randn((2, 52, 100, 64), 64, dtype, cuda) * 4,)
        fn, wrapper = torch.ops.camradepth.gelu_bf16, gelu_bf16
        want = gelu_bf16_reference(*args)
    before = wrapper.launches
    with torch.no_grad():
        got = fn(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    if op == "scores":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16
                                     else torch.int32))
    with FakeTensorMode() as mode:
        fake = fn(*(mode.from_tensor(a) if torch.is_tensor(a) else a
                    for a in args))
    assert (fake.shape, fake.dtype, fake.device) == (got.shape, got.dtype,
                                                      got.device)
    assert wrapper.launches == before + 1


@pytest.mark.parametrize("traced_on,dtype", [("cuda", "bfloat16"),
                                             ("cpu", "float32")])
def test_artifact_on_the_card_launches_the_kernels(cuda, tmp_path,
                                                   traced_on, dtype):
    """A serving artifact of the tiny widths, exported on the card (bf16)
    or on the CPU (fp32: no Python branch of the forward depends on the
    device), serves on the card through the kernels (4 attention, 5
    bicubic and, in bf16, one GELU launch per GELU of the live forward)
    and equals the live engine there bit for bit: the same kernels and
    library calls in the same order."""
    from camradepth_tpu_torch.config import tiny_test_config
    from camradepth_tpu_torch.interop.export import (
        artifact_engine,
        export_serving_artifact,
    )
    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.serving import DepthEngine

    cfg = tiny_test_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype=dtype))
    sd = create_model(cfg.model, device="cpu", seed=4).state_dict()
    path = tmp_path / "a.pt2"
    export_serving_artifact(
        cfg, create_model(cfg.model, device=traced_on, state_dict=sd),
        str(path), batch_size=2, artifact_dtype=dtype)
    live = DepthEngine(cfg, create_model(cfg.model, device=cuda,
                                         state_dict=sd),
                       batch_size=2, device=cuda)
    eng = artifact_engine(str(path), cfg, device=cuda)
    eng.warmup()
    live.warmup()
    x = np.random.default_rng(9).standard_normal(
        (2, *cfg.model.img_size, 7)).astype(np.float32)
    wrappers = (maxpool_attention_scores, upsample_bicubic_x2, gelu_bf16)
    counts, outs = [], []
    for e in (eng, live):
        before = [w.launches for w in wrappers]
        outs.append(e.infer_batch(x)["depth"])
        counts.append([w.launches - b for w, b in zip(wrappers, before)])
    assert counts[0] == counts[1] and counts[0][:2] == [4, 5], counts
    assert (counts[0][2] > 0) == (dtype == "bfloat16")
    assert np.array_equal(outs[0], outs[1])


def _vmap_counters():
    from camradepth_tpu_torch.ops import attention, gelu, resize

    return {
        "scores": attention.maxpool_attention_scores,
        "scores_bwd": attention.maxpool_attention_scores_backward,
        "upsample": resize.upsample_bicubic_x2,
        "upsample_bwd": resize.upsample_bicubic_x2_backward,
        "gelu": gelu.gelu_bf16,
        "gelu_bwd": gelu.gelu_bf16_backward,
    }


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trials", [1, 4])
def test_vmap_rules_launch_once_for_every_trial(cuda, dtype, trials):
    """Each launch point under torch.func.vmap over ``trials``: one launch
    for the whole trial-batched call, equal to the kernel on each trial
    alone (and, through the tests above, to the plain version)."""
    from camradepth_tpu_torch.ops import attention, gelu, resize

    vmap = torch.func.vmap
    t, b, n, m, c, heads = trials, 2, 1001, 77, 120, 3
    q = _randn((t, b, n, c), 0, dtype, cuda)
    k = _randn((t, b, m, c), 1, dtype, cuda)
    g = _randn((t, b, n), 2, torch.float32, cuda)
    x = _randn((t, b, 13, 25, 129), 3, dtype, cuda)
    gy = _randn((t, b, 26, 50, 129), 4, dtype, cuda)
    scale = (c // heads) ** -0.5
    count = _vmap_counters()

    def once(name, fn, *args):
        before = count[name].launches
        out = fn(*args)
        torch.cuda.synchronize()
        assert count[name].launches == before + 1, name
        return out, None

    s, amax = once("scores", vmap(
        lambda a, b_: attention.maxpool_attention_scores_with_argmax(
            a, b_, heads, scale)), q, k)[0]
    dq, dk = once("scores_bwd", vmap(
        lambda a, b_, i, gg: attention.maxpool_attention_scores_backward(
            a, b_, i, gg, heads, scale)), q, k, amax, g)[0]
    s_nograd = once("scores", vmap(
        lambda a, b_: attention.maxpool_attention_scores(a, b_, heads,
                                                         scale)), q, k)[0]
    y = once("upsample", vmap(resize.upsample_bicubic_x2), x)[0]
    gx = once("upsample_bwd", vmap(resize.upsample_bicubic_x2_backward),
              gy)[0]
    for i in range(t):
        si, ai = attention.maxpool_attention_scores_with_argmax(
            q[i], k[i], heads, scale)
        assert torch.equal(s[i], si) and torch.equal(amax[i], ai)
        assert torch.equal(s_nograd[i], attention.maxpool_attention_scores(
            q[i], k[i], heads, scale))
        dqi, dki = attention.maxpool_attention_scores_backward(
            q[i], k[i], amax[i], g[i], heads, scale)
        assert torch.equal(dq[i], dqi)
        # dk's fp32 sums may run in another order at another launch shape
        if dtype == torch.bfloat16:
            assert _bf16_ulps(dk[i], dki) <= 1.0
        else:
            torch.testing.assert_close(dk[i], dki, rtol=1e-5, atol=1e-5)
        assert torch.equal(y[i], resize.upsample_bicubic_x2(x[i]))
        assert torch.equal(gx[i], resize.upsample_bicubic_x2_backward(gy[i]))
    if dtype == torch.bfloat16:
        xb = _randn((t, b, 52, 100, 64), 5, dtype, cuda) * 3
        gb = _randn((t, b, 52, 100, 64), 6, dtype, cuda)
        out = once("gelu", vmap(gelu.gelu_bf16), xb)[0]
        vjp = once("gelu_bwd", vmap(gelu.gelu_bf16_backward), xb, gb)[0]
        assert torch.equal(out, gelu_bf16_reference(xb))
        assert torch.equal(vjp, gelu_bf16_backward_reference(xb, gb))


def test_vmapped_trial_step_launches_once_per_call(cuda):
    """One bf16 vmapped trial step of a small CamRaDepth for 3 trials: per
    microbatch the kernels launch as often as for one trial (34 encoder
    blocks are 4 here: 4 + 4 attention, 5 + 5 bicubic launches), and each
    trial's loss is that of a one-trial step, within the bf16 step's
    limit."""
    from camradepth_tpu_torch.config import tiny_test_config
    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.train import search

    cfg = tiny_test_config()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16", dropout_rate=0.0))
    model = create_model(cfg.model, device=cuda, seed=0, train=True)
    v_step, v_val, make_state = search._vmapped_machinery(cfg, model, 3,
                                                          cuda)
    rng = np.random.default_rng(0)
    micro = search._device_tree({
        "features": rng.standard_normal((1, 2, 64, 128, 7)).astype(
            np.float32),
        "gt_depth": rng.random((1, 2, 64, 128)).astype(np.float32)}, cuda)
    count = _vmap_counters()
    lrs = torch.tensor([1e-4, 1e-3, 1e-2], device=cuda)
    wds = torch.zeros(3, device=cuda)
    before = {k: v.launches for k, v in count.items()}
    params, opt = make_state(3)
    _, _, losses = v_step(params, opt, lrs, wds, micro, [None], 0)
    torch.cuda.synchronize()
    got = {k: v.launches - before[k] for k, v in count.items()}
    assert got["scores"] == got["scores_bwd"] == 4, got
    assert got["upsample"] == got["upsample_bwd"] == 5, got
    assert got["gelu"] == got["gelu_bwd"] > 0, got
    p1, o1 = make_state(1)
    one = v_step(p1, o1, lrs[:1], wds[:1], micro, [None], 0)[2]
    # bf16: cuDNN takes other algorithms for the grouped convolutions of 3
    # trials than for 1 (measured 4.0e-5 relative); the bf16 step's loss
    # limit of PERF.md section 2
    torch.testing.assert_close(losses, one.expand(3), rtol=2e-3, atol=0)


def test_run_bench_on_the_card(cuda):
    """bench.run_bench at base 416x800, bf16, batch 8 on the card: each
    timed forward launches 34 / 5 / 53 kernels (base + tpu_decoder: 34 / 3
    / 53), and the roofline's attainable floor lies at or under the
    measured ms per frame."""
    from camradepth_tpu_torch import bench
    from camradepth_tpu_torch.config import preset

    cfg = preset("base")
    for tpu_decoder, want in ((False, (34, 5, 53)), (True, (34, 3, 53))):
        c = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  tpu_decoder=tpu_decoder))
        r = bench.run_bench(c, device=cuda, batch=8, iters=4)
        got = tuple(r["launches_per_forward"][k] for k in (
            "maxpool_attention_scores", "upsample_bicubic_x2", "gelu_bf16"))
        assert got == want, got
        assert r["fps"] > 0 and r["batch1_latency_ms"] > 0
        assert 0 < r["attainable_ms_per_frame"] <= 1e3 / r["fps"], r
