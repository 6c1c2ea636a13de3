"""The port's backward passes and small training modules against the JAX
package, on the CPU (where each kernel wrapper runs its plain version).

Tolerances:
- attention scores, fp32: the port's gather/scatter-add backward against
  JAX's custom VJP and its autodiff oracle, rtol 1e-5, atol 1e-6 (the
  limits of tests/test_ops.py:100-134). bf16: the argmax is taken over fp32
  sums of exact bf16 products, which the two frameworks add in other
  orders, so a key whose dot lies within that roundoff of the row's
  maximum (a near tie: the top two dots closer than 1e-4 * (1 + |max|))
  may win on one side and lose on the other. The argmaxes must be equal
  off the near ties, and at a near tie the port's key must be one of the
  tied ones; the test counts the near ties. dq and dk are then compared
  for JAX's argmax: dq bit for bit (one product per element), dk within
  1 bf16 ulp (its fp32 sums run in another order before the rounding);
- bicubic x2 VJP, fp32: 1e-5 (tests/test_resize_pallas.py:38-57). bf16:
  bit for bit everywhere, edges included, also where one or two rows or
  columns make both edges' folds land on the same ones. Both take each
  axis back over its edge-padded length in fp32 and round it to bf16, then
  fold the pads into the edge rows by bf16 adds in XLA's order (the last
  two pads into row n - 1, then the first two into row 0), W before H;
- bf16 GELU VJP: bit for bit with JAX on every finite bf16 input above
  XLA's subnormal flush (|x| > 1e-30), for several cotangents;
- min-pool pyramid: exact; losses: rtol 1e-6; diffGradNorm over 5 steps
  fed the same gradients: elementwise 1e-6; OneCycle: rtol 1e-6 against
  the JAX schedule, which evaluates in fp32 (atol 1e-11: near the end
  cos(pi * pct) + 1 cancels, and its fp32 roundoff times max_lr remains),
  rtol 1e-5 against torch's OneCycleLR (the limit of
  tests/test_optimizer.py:108-124).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camradepth_tpu.ops import attention as jattn
from camradepth_tpu.ops import pooling as jpool
from camradepth_tpu.ops import resize as jresize
from camradepth_tpu.train import diffgrad as jdiffgrad
from camradepth_tpu.train import losses as jlosses
from camradepth_tpu.train import schedule as jschedule
from camradepth_tpu_torch.config import tiny_test_config
from camradepth_tpu_torch.ops.attention import (
    maxpool_attention_scores,
    maxpool_attention_scores_argmax_reference,
    maxpool_attention_scores_backward_reference,
    scores_backward_plan,
)
from camradepth_tpu_torch.ops.gelu import gelu_bf16, gelu_bf16_backward
from camradepth_tpu_torch.ops.pooling import minpool_pyramid, minpool_sparse
from camradepth_tpu_torch.ops.resize import (
    ADJOINT_TAPS,
    SMEM_MAX,
    upsample_backward_plan,
    upsample_bicubic_x2,
    upsample_bicubic_x2_backward_reference,
    upsample_bicubic_x2_reference,
)
from camradepth_tpu_torch.train import losses as tlosses
from camradepth_tpu_torch.train.diffgrad import DiffGradNorm
from camradepth_tpu_torch.train.schedule import onecycle
from tests.torch_port import one_torch_thread  # noqa: F401

BF16_EPS = 2.0 ** -7


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


def _bf16_ulps(got, want):
    """Largest |got - want| in bf16 ulps of the larger magnitude (fp32
    numpy arrays holding bf16 values); zeros compare at the smallest
    normal."""
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
    ulp = BF16_EPS * np.exp2(np.floor(np.log2(mag)))
    return float(np.max(np.abs(got - want) / ulp))


# ---- attention scores ----------------------------------------------------

def test_attention_backward_matches_jax_custom_vjp_and_oracle():
    b, n, m, c, heads, scale = 2, 12, 5, 8, 2, 0.7
    q, k, g = _rand((b, n, c), 3), _rand((b, m, c), 4), _rand((b, n), 5)

    def plain(q, k):
        d = c // heads
        scores = jnp.einsum("bnhd,bmhd->bhnm", q.reshape(b, n, heads, d),
                            k.reshape(b, m, heads, d)) * scale
        return jnp.sum(jnp.max(scores, -1), axis=1)

    def loss(fn):
        return lambda q, k: jnp.sum(fn(q, k) * g)

    custom = jax.grad(loss(partial(jattn.maxpool_attention_scores,
                                   num_heads=heads, scale=scale)),
                      argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))
    oracle = jax.grad(loss(plain), argnums=(0, 1))(jnp.asarray(q),
                                                    jnp.asarray(k))
    tq = torch.from_numpy(q).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    s = maxpool_attention_scores(tq, tk, heads, scale)
    got = torch.autograd.grad(s, (tq, tk), torch.from_numpy(g))
    for want in (custom, oracle):
        for a, w in zip(got, want):
            np.testing.assert_allclose(_np(a), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)


def test_attention_backward_bf16_matches_jax_off_near_ties():
    b, n, m, c, heads = 2, 96, 19, 80, 2  # d = 40
    scale = (c // heads) ** -0.5
    q = torch.from_numpy(_rand((b, n, c), 6)).to(torch.bfloat16)
    k = torch.from_numpy(_rand((b, m, c), 7)).to(torch.bfloat16)
    g = _rand((b, n), 8)
    jq = jnp.asarray(q.float().numpy(), jnp.bfloat16)
    jk = jnp.asarray(k.float().numpy(), jnp.bfloat16)
    s_jax, amax_jax = jattn._scores_and_argmax(jq, jk, heads, scale)
    s, amax = maxpool_attention_scores_argmax_reference(q, k, heads, scale)
    np.testing.assert_allclose(_np(s), np.asarray(s_jax), rtol=1e-5,
                               atol=1e-5)
    # near ties from exact (fp64) dots of the bf16 values
    d = c // heads
    dots = np.einsum("bnhd,bmhd->bhnm",
                     q.double().numpy().reshape(b, n, heads, d),
                     k.double().numpy().reshape(b, m, heads, d))
    top2 = -np.sort(-dots, axis=-1)[..., :2]
    tie = top2[..., 0] - top2[..., 1] <= 1e-4 * (1 + np.abs(top2[..., 0]))
    amax_jax = np.asarray(amax_jax)
    assert np.all((amax.numpy() == amax_jax) | tie)
    picked = np.take_along_axis(dots, amax.long().numpy()[..., None], -1)
    assert np.all(top2[..., 0] - picked[..., 0]
                  <= 1e-4 * (1 + np.abs(top2[..., 0])))
    # the backward for JAX's argmax
    dq_j, dk_j = jattn._scores_bwd(heads, scale,
                                   (jq, jk, jnp.asarray(amax_jax)),
                                   jnp.asarray(g))
    dq, dk = maxpool_attention_scores_backward_reference(
        q, k, torch.from_numpy(amax_jax.astype(np.int32)),
        torch.from_numpy(g), heads, scale)
    assert dq.dtype == dk.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(dq), np.asarray(dq_j, np.float32))
    assert _bf16_ulps(_np(dk), np.asarray(dk_j, np.float32)) <= 1.0
    print(f"near ties: {int(tie.sum())} of {tie.size} rows")


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("b,n,m,c,heads", [
    (2, 20800, 325, 64, 1), (2, 5200, 325, 128, 2), (2, 1300, 325, 160, 4),
    (2, 325, 325, 256, 8), (3, 1001, 77, 120, 3), (1, 37, 1, 40, 1),
    (1, 9, 5000, 8, 1)])
def test_scores_backward_plan_covers_every_token_and_key(b, n, m, c, heads,
                                                         itemsize):
    """Pass 1's chunks cover the tokens once, at most one per thread; a
    chunk's slots hold every key it can hit; its shared memory fits; and
    the blocks fill the card where the tokens allow."""
    plan = scores_backward_plan(b, n, m, c, heads, itemsize, 132)
    assert plan.chunks * plan.tokens >= n > (plan.chunks - 1) * plan.tokens
    assert plan.tokens in (32, 64, 128, 256)
    assert plan.slots == min(plan.tokens, m)
    assert plan.smem <= 232448
    assert plan.tokens == 32 or b * heads * plan.chunks >= 132
    # the shared memory is the buffers the plan lists, in order
    q_slice = -(-plan.tokens * (c // heads) * itemsize // 16) * 16
    assert plan.smem == (q_slice + 8 * plan.slots
                         + 4 * (3 * plan.tokens + 2 * m + 2 * 8))
    # tokens set directly, as the diagnostics sweep them
    assert scores_backward_plan(b, n, m, c, heads, itemsize, 132, 64)[:3] == (
        64, -(-n // 64), min(64, m))


def test_scores_backward_plan_refuses_what_shared_memory_cannot_hold():
    assert scores_backward_plan(1, 9, 20000, 64, 1, 4, 132).smem <= 232448
    with pytest.raises(ValueError, match="shared memory"):
        scores_backward_plan(1, 9, 30000, 64, 1, 4, 132)
    with pytest.raises(ValueError, match="tokens per chunk"):
        scores_backward_plan(1, 9, 5, 64, 1, 4, 132, 512)


# ---- bicubic x2 ----------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 9])
def test_adjoint_coefficients_are_the_forward_transposed(n):
    """The fp32 adjoint of a unit cotangent at output o is column o of the
    forward's response to unit inputs, edge folds included (exact: the
    weights are dyadic with few bits); away from the edges an input takes
    the eight interleaved taps."""
    eye = torch.eye(n).reshape(n, n, 1, 1)  # n unit images [n, H=n, 1, 1]
    a = upsample_bicubic_x2_reference(eye)[:, :, 0, 0]  # [i, o] (W: n=1)
    # the W axis of a 1-wide image replicates, so its weights sum to 1 and
    # leave the H response as it is: one unit per image, at column 0
    units = torch.zeros(2 * n, 2 * n, 2, 1)
    units[:, :, 0, 0] = torch.eye(2 * n)
    back = upsample_bicubic_x2_backward_reference(units)[:, :, 0, 0]  # [o, i]
    assert torch.equal(back.T, a)
    for i in range(2, n - 2):
        assert tuple(a[i, 2 * i - 3:2 * i + 5].tolist()) == ADJOINT_TAPS


def _adjoint_reads(n):
    """For each of n gx columns: the gy columns of 2n its adjoint reads,
    edge folds included, from the plain version on unit cotangents (H 1
    high)."""
    units = torch.zeros(2 * n, 2, 2 * n, 1)
    o = torch.arange(2 * n)
    units[o, 0, o, 0] = 1.0
    back = upsample_bicubic_x2_backward_reference(units)[:, 0, :, 0]
    return [set(torch.nonzero(back[:, i]).flatten().tolist())
            for i in range(n)]


@pytest.mark.parametrize("shape,itemsize,sms", [
    # both W folds in one run (n = 1, 2, 3)
    ((1, 1, 3, 2), 2, 132), ((2, 2, 1, 4), 4, 132), ((1, 3, 3, 5), 2, 132),
    # strip boundaries mid-image, a ragged last run, two channel tiles
    ((2, 37, 50, 129), 2, 132), ((2, 37, 50, 129), 4, 1),
    ((1, 9, 7, 300), 2, 132),
    # the decoder's two largest and its widest inputs, batch 2
    ((2, 208, 400, 129), 2, 132), ((2, 104, 200, 129), 4, 132),
    ((2, 13, 25, 256), 2, 132),
])
def test_upsample_backward_plan_covers_gx_once_with_its_halo(shape, itemsize,
                                                             sms):
    """The launch the adjoint kernel takes as given: its strips, runs of 4
    columns and channel tiles cover every gx row, column and channel once;
    a staged gy row holds every gy column a run's gx columns read (the
    edge folds' too, from the plain version) and its 16-byte slack at each
    end, a staged gx row the run's columns and the slack before them; the
    shared memory is the buffers the plan lists and fits. (Which gy rows a
    strip streams is the kernel's: the card's strip tests hold them.)"""
    b, h, w, c = shape
    n = 16 // itemsize
    plan = upsample_backward_plan(b, h, w, c, itemsize, sms)
    runs, strips, bb = plan.grid
    assert bb == b and plan.smem <= SMEM_MAX
    assert (strips - 1) * plan.rows < h <= strips * plan.rows
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    assert (plan.tiles - 1) * plan.threads < c <= plan.tiles * plan.threads
    assert runs == -(-w // 4) * plan.tiles
    reads = _adjoint_reads(w)
    for run in range(runs // plan.tiles):
        cols = set().union(*reads[4 * run:4 * run + 4])
        assert (max(cols) - min(cols) + 1) * c + 2 * n <= plan.rowcap, run
    assert plan.rowcap % n == 0 and plan.ocap % n == 0
    assert 4 * c + n <= plan.ocap
    assert plan.smem == (8 * plan.rowcap + 2 * plan.ocap
                         + 12 * plan.threads) * itemsize
    assert upsample_backward_plan(b, h, w, c, itemsize, sms, 3)[:3] == (
        plan.threads, plan.tiles, 3)


def test_upsample_backward_plan_refuses_what_shared_memory_cannot_hold():
    assert upsample_backward_plan(1, 8, 8, 941, 2, 132).smem <= SMEM_MAX
    assert upsample_backward_plan(1, 8, 8, 458, 4, 132).smem <= SMEM_MAX
    for c, itemsize in ((942, 2), (459, 4)):
        with pytest.raises(ValueError, match="shared memory"):
            upsample_backward_plan(1, 8, 8, c, itemsize, 132)
    with pytest.raises(ValueError, match="empty"):
        upsample_backward_plan(1, 0, 8, 3, 2, 132)


@pytest.fixture(scope="module")
def jax_upsample_vjp():
    return jax.jit(lambda x, g: jax.vjp(jresize.upsample_bicubic_x2, x)[1](g)[0])


@pytest.mark.parametrize("shape", [(2, 8, 16, 3), (1, 5, 7, 129),
                                   (1, 1, 3, 2), (2, 2, 1, 4)])
def test_upsample_vjp_matches_jax_fp32(jax_upsample_vjp, shape):
    x = _rand(shape, 9)
    gy = _rand((shape[0], 2 * shape[1], 2 * shape[2], shape[3]), 10)
    want = jax_upsample_vjp(jnp.asarray(x), jnp.asarray(gy))
    tx = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(upsample_bicubic_x2(tx), tx,
                                 torch.from_numpy(gy))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 9, 14, 129), (1, 1, 3, 2),
                                   (2, 2, 1, 4), (1, 5, 7, 129)])
def test_upsample_vjp_matches_jax_bf16(jax_upsample_vjp, shape):
    x = torch.from_numpy(_rand(shape, 11)).to(torch.bfloat16)
    gy = torch.from_numpy(_rand(
        (shape[0], 2 * shape[1], 2 * shape[2], shape[3]), 12)
    ).to(torch.bfloat16)
    want = np.asarray(jax_upsample_vjp(
        jnp.asarray(x.float().numpy(), jnp.bfloat16),
        jnp.asarray(gy.float().numpy(), jnp.bfloat16)), np.float32)
    tx = x.clone().requires_grad_()
    (got,) = torch.autograd.grad(upsample_bicubic_x2(tx), tx, gy)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), want)


# ---- bf16 GELU -----------------------------------------------------------

def test_gelu_bf16_vjp_matches_jax_on_every_input():
    bits = np.arange(-(1 << 15), 1 << 15, dtype=np.int32).astype(np.int16)
    x = torch.from_numpy(bits).view(torch.bfloat16)
    xf = x.float().numpy()
    keep = np.isfinite(xf) & (np.abs(xf) > 1e-30)
    jx = jnp.asarray(xf, jnp.bfloat16)
    vjp = jax.jit(lambda x, g: jax.vjp(partial(jax.nn.gelu, approximate=True),
                                       x)[1](g)[0])
    rng = np.random.default_rng(13)
    for gy in (np.ones_like(xf), np.full_like(xf, -0.3125),
               np.full_like(xf, 3.5), rng.standard_normal(xf.shape)):
        gb = torch.from_numpy(gy.astype(np.float32)).to(torch.bfloat16)
        want = np.asarray(vjp(jx, jnp.asarray(gb.float().numpy(),
                                              jnp.bfloat16)), np.float32)
        tx = x.clone().requires_grad_()
        (got,) = torch.autograd.grad(gelu_bf16(tx), tx, gb)
        assert torch.equal(got.view(torch.int16),
                           gelu_bf16_backward(x, gb).view(torch.int16))
        got = _np(got)
        same = (got == want) | (np.isnan(got) & np.isnan(want))
        bad = keep & ~same
        assert not bad.any(), (xf[bad][:5], got[bad][:5], want[bad][:5])


# ---- small modules -------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16, 32), (1, 15, 9), (3, 1, 5)])
def test_minpool_matches_jax(shape):
    x = np.abs(_rand(shape, 14))
    x[np.random.default_rng(15).uniform(size=shape) < 0.7] = 0.0
    want = jpool.minpool_pyramid(jnp.asarray(x))
    got = minpool_pyramid(torch.from_numpy(x))
    for a, w in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(w))
    np.testing.assert_array_equal(
        _np(minpool_sparse(torch.from_numpy(x))),
        np.asarray(jpool.minpool_sparse(jnp.asarray(x))))


def test_losses_match_jax():
    b, h, w = 2, 16, 24
    pred = _rand((b, h, w), 16, 0.3) + 0.5
    target = np.abs(_rand((b, h, w), 17, 0.3)) + 0.1
    target[np.random.default_rng(18).uniform(size=target.shape) < 0.6] = 0.0
    logits = _rand((b, h, w, 5), 19)
    labels = np.random.default_rng(20).integers(0, 5, (b, h, w))
    labels[0, :3] = 255
    depth = np.abs(_rand((b, h, w, 1), 21)) + 0.1
    image = _rand((b, h, w, 3), 22)
    names = ("masked_smooth_l1", "masked_mse", "masked_l1", "masked_rmse",
             "masked_huber", "masked_berhu")

    def all_losses(lib, pred, target, logits, labels, depth, image):
        return [getattr(lib, n)(pred, target) for n in names] + [
            lib.masked_focal_ce(logits, labels),
            lib.smoothness_loss(depth, image)]

    args = (pred, target, logits, labels, depth, image)
    want = jax.jit(partial(all_losses, jlosses))(*map(jnp.asarray, args))
    got = all_losses(tlosses, *map(torch.from_numpy, args))
    for name, a, w in zip(names + ("masked_focal_ce", "smoothness_loss"),
                          got, want):
        np.testing.assert_allclose(float(a), float(w), rtol=1e-6,
                                   err_msg=name)


def test_multitask_loss_matches_jax():
    from camradepth_tpu.config import tiny_test_config as jax_tiny

    b, h, w = 2, 16, 32
    pred = {"depth": {"final_depth": _rand((b, h, w, 1), 23),
                      "intermediate_depths": (
                          None, None, _rand((b, h // 4, w // 4, 1), 24),
                          _rand((b, h // 2, w // 2, 1), 25))},
            "seg": {"final_seg": None, "intermediate_seg": None,
                    "unsup_map": None}}
    gt = {"depth": np.abs(_rand((b, h, w), 26)),
          "depth_stage4": np.abs(_rand((b, h // 2, w // 2), 27)),
          "depth_stage3": np.abs(_rand((b, h // 4, w // 4), 28)),
          "seg": None, "seg_inter": None}
    for v in ("depth", "depth_stage4", "depth_stage3"):
        gt[v][gt[v] < 0.5] = 0.0
    conv = {np.ndarray: torch.from_numpy, type(None): lambda v: v}

    def tree(t, fn):
        if isinstance(t, dict):
            return {k: tree(v, fn) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(tree(v, fn) for v in t)
        return fn(t)

    _, want = jlosses.multitask_loss(tree(pred, lambda v: v),
                                     tree(gt, lambda v: v), jax_tiny())
    _, got = tlosses.multitask_loss(tree(pred, lambda v: conv[type(v)](v)),
                                    tree(gt, lambda v: conv[type(v)](v)),
                                    tiny_test_config())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_diffgrad_matches_jax_over_five_steps(weight_decay):
    shapes = [(4, 3), (7,), (2, 3, 5)]
    params = [_rand(s, 30 + i) for i, s in enumerate(shapes)]
    # gradients of several sizes, one far smaller than the norm EMA so the
    # AdaNorm correction scales it up
    scales = [1.0, 0.5, 2.0, 1e-4, 1.0]
    grads = [[_rand(s, 40 + 10 * t + i, scales[t])
              for i, s in enumerate(shapes)] for t in range(5)]
    lr = 1e-2
    tx = jdiffgrad.diffgrad_norm(lr, weight_decay=weight_decay)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    opt = DiffGradNorm(tp, lr=lr, weight_decay=weight_decay)
    for t in range(5):
        upd, state = update([jnp.asarray(g) for g in grads[t]], state, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        for p, g in zip(tp, grads[t]):
            p.grad = torch.from_numpy(g)
        opt.step()
        for a, w in zip(tp, jp):
            np.testing.assert_allclose(_np(a), np.asarray(w), rtol=0,
                                       atol=1e-6, err_msg=f"step {t}")


def test_onecycle_matches_jax_and_torch():
    total = 40
    got = onecycle(6e-5, total, pct_start=0.15, div_factor=2.0)
    want = jschedule.onecycle(6e-5, total, pct_start=0.15, div_factor=2.0)
    np.testing.assert_allclose([got(i) for i in range(total)],
                               [float(want(i)) for i in range(total)],
                               rtol=1e-6, atol=1e-11)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=1.0)
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=6e-5, total_steps=total, div_factor=2, pct_start=0.15)
    torch_lrs = []
    for _ in range(total):
        torch_lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose([got(i) for i in range(total)], torch_lrs,
                               rtol=1e-5, atol=1e-12)
