"""Spatially sharded training of the port (``Layout(sp=2)``: cli train and
cli distill ``--spatial-parallel 2``) on the CPU, against the port's
single-process step and the JAX package's gradients and refusals.

The module starts one gloo group of two processes
(``tests/_torch_spatial_train_child.py``, forked by ``tests/torch_ranks.py``
from one process that imports their code once; one torch thread each,
tiny widths, fp32, 96x64 images: 2 and 1 rows at /32, so the ranks' rows
are uneven) when it starts, compiles the JAX gradient on a thread, runs
the single-process ``cli train`` and the tests that need no process
meanwhile, then reads what each rank reports. Limits, those of the DDP
and FSDP2 checks (``tests/test_torch_parallel.py``):

- two optimizer steps of tiny ``base`` and of tiny ``sup_unsup_seg`` +
  ``tpu_decoder`` (dropout on, drawn alike on both ranks; the GT of the
  second rank's rows at most 10 % valid, its labels 95 % ignored), and
  one distill step (a ``sup_unsup_seg`` teacher into a ``sup_unsup_seg`` +
  ``tpu_decoder`` student) against the single-process step: the loss
  rtol 1e-6 in each step, each parameter's gradient in the last step
  relative L2 1e-5, the parameters after the steps relative L2 1e-5 over
  all of them together; the metrics bit for bit on both ranks. The seg
  microbatches' seed keeps every guidance pixel's two largest logits more
  than twice the sharded logits' difference from them apart (asserted),
  so no argmax flips between the two runs;
- ``grad_parity`` on the layout: each parameter within 1e-5 of its
  largest gradient, the loss within 1e-6;
- the sp = 2 gradients of tiny ``base`` (JAX-initialised weights, one
  microbatch, dropout off) against the JAX package's ``jax.value_and_grad``
  of its ``multitask_loss`` on one device (which equals its sp = 2
  gradient: ``tests/test_gradcheck.py::test_sp2_sole_axis_exact``): the
  fp32 step limits of ``tests/test_torch_train.py``, loss rtol 1e-5 and
  each parameter's gradient relative L2 1e-4;
- ``cli train --spatial-parallel 2`` over the two processes against
  single-process ``cli train`` on the same corpus and flags: the val loss
  rtol 1e-6, the best checkpoint (the single-device layout, written by
  rank 0 alone) relative L2 1e-5 over all parameters.

Without processes, the ranks of an sp group run as threads of this one
(``tests/spatial_port.py``), at sp = 2 on a 96-row image (2 and 1 rows at
/32) and at sp = 3 on a 128-row one (2, 1 and 1): the input gradient of
every sharded op (each convolution shape of the model, the depthwise 3x3,
the bicubic x2 in fp32 and bf16, GroupNorm, the token mean, the keys'
all-gather) equals the rows of the whole op's input gradient, fp32 rtol
1e-5 and atol 1e-6 (bf16: within 2 bf16 ulps of the largest gradient of
its (sample, channel) plane, see ``_check_grads``), and the parameter
gradients summed over the ranks equal the
whole op's, rtol 1e-5 and atol 1e-5 of their largest; a halo whose
gradient is dropped fails that. A ``remat`` block's backward run on a
fresh thread (the autograd engine's device thread on the card starts with
no spatial shard) equals its backward on the calling thread bit for bit,
and without the shard captured at the forward it does not. The
refusals of ``--spatial-parallel`` on ``cli train`` and ``cli distill``
name the causes the JAX trainer names (``_auto_mesh``, the wire check).
"""

import concurrent.futures
import copy
import dataclasses
import functools
import json
import socket
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camradepth_tpu.config import ConfigError as JaxConfigError
from camradepth_tpu.config import MeshConfig as JaxMeshConfig
from camradepth_tpu.config import tiny_test_config as jax_tiny_config
from camradepth_tpu.models.camradepth import CamRaDepth as JaxCamRaDepth
from camradepth_tpu.train.losses import multitask_loss as jax_multitask_loss
from camradepth_tpu.train.step import build_gt as jax_build_gt
from camradepth_tpu_torch import cli
from camradepth_tpu_torch.data import synthetic
from camradepth_tpu_torch.interop.flax_convert import state_dict_from_flax
from camradepth_tpu_torch.models import layers
from camradepth_tpu_torch.models.encoder import Block
from camradepth_tpu_torch.models.layers import Conv2d, upsample_rows_x2
from camradepth_tpu_torch.ops.attention import maxpool_attention
from camradepth_tpu_torch.ops.groupnorm import group_norm
from camradepth_tpu_torch.parallel import gradcheck as gc
from camradepth_tpu_torch.parallel import multihost, spatial
from camradepth_tpu_torch.utils import checkpoint as ckpt_util
from tests import torch_ranks
from tests.spatial_port import on_threads
from tests.test_torch_train import _flax_params
from tests.torch_port import one_torch_thread  # noqa: F401

CHILD = "tests._torch_spatial_train_child"
WORLD = 2
HW = gc.SP_HW
STEP_LIMITS = dict(loss_rel=1e-6, grad_rel=1e-5, params_rel=1e-5)
# the JAX gradient's compile: XLA's own passes, then no LLVM optimization
# (as tests/test_torch_spatial.py compiles its forwards)
JAX_COMPILE = {"xla_backend_optimization_level": 0}
# cli train's tiny widths at 96x64: 4 train frames (2 optimizer steps of
# batch 2), 2 val frames, one epoch, fp32
TRAIN_FLAGS = ["--train-val-split", "4,2", "--batch-size", "2",
               "--desired-batch-size", "2", "--num-epochs", "1",
               "--save-model", "--device", "cpu", "--compute-dtype",
               "float32"] + [a for kv in (
                   "model.img_size=96,64", "model.dims=16,32,32,64",
                   "model.ff_expansion=2,2,2,2", "model.depths=1,1,1,1",
                   "model.mid_channels=32", "data.image_dimension=96,64",
                   "data.num_workers=1") for a in ("--set", kv)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


@pytest.fixture(scope="module")
def in_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("sp_train_in")


@pytest.fixture(scope="module", autouse=True)
def spawned(in_dir, tmp_path_factory):
    """The two ranks, started with the module: their steps need nothing
    from it; they read ``spec.json`` for the rest."""
    out = tmp_path_factory.mktemp("sp_train_out")
    proc = torch_ranks.start(CHILD, WORLD, in_dir, out, _free_port(),
                             _free_port())
    try:
        yield proc, out
    finally:
        torch_ranks.stop(proc)


def _jax_cfg():
    cfg = jax_tiny_config()
    return cfg.replace(model=dataclasses.replace(
        cfg.model, img_size=HW, compute_dtype="float32", drop_path_rate=0.0,
        dropout_rate=0.0))


@pytest.fixture(scope="module", autouse=True)
def inputs(in_dir, spawned):
    """The JAX-initialised weights and microbatch, the corpus and the
    train flags, written for the ranks (``spec.json`` last); and the JAX
    loss and gradients of that microbatch, compiled on a thread."""
    d = in_dir
    cfg = _jax_cfg()
    model = JaxCamRaDepth(cfg.model)
    params = _flax_params(model, jnp.zeros((1, *HW, 7)), seed=4)
    micro = gc.parity_microbatches(gc.check_config(hw=HW), 1, 2, seed=11,
                                   ranks=WORLD, image_rows=True)[0]
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in
                               state_dict_from_flax(params).items()}},
               d / "jax_base.pth")
    np.savez(d / "jax_micro.npz", **micro)

    def loss(p, m):
        pred = model.apply({"params": p}, m["features"], deterministic=True)
        return jax_multitask_loss(pred, jax_build_gt(m), cfg)[0]

    jm = {k: jnp.asarray(v) for k, v in micro.items()}
    lowered = jax.jit(jax.value_and_grad(loss)).lower(params, jm)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        compiled = pool.submit(lowered.compile, JAX_COMPILE)
        split = synthetic.generate(d / "corpus", num_frames=6, hw=HW, seed=3)
        flags = ["--split", str(split)] + TRAIN_FLAGS
        spec = d / "spec.json.tmp"
        spec.write_text(json.dumps({"train_flags": flags}))
        spec.rename(d / "spec.json")
        yield flags, pool.submit(
            lambda: compiled.result()(params, jm))


@pytest.fixture(scope="module")
def single_cli(inputs, tmp_path_factory):
    """Single-process cli train on the ranks' corpus and flags (the
    metric writer without TensorBoard, which pulls in TensorFlow here)."""
    run = tmp_path_factory.mktemp("sp_train_single") / "run"
    saved = sys.modules.get("tensorboard", False)
    sys.modules["tensorboard"] = None  # import raises ImportError
    try:
        assert cli.main(["train", "--run-dir", str(run)] + inputs[0]) == 0
    finally:
        if saved is False:
            del sys.modules["tensorboard"]
        else:
            sys.modules["tensorboard"] = saved
    return run


@pytest.fixture(scope="module")
def ranks(spawned):
    """Both ranks' reports and their output directory."""
    proc, out = spawned
    torch_ranks.wait(proc, WORLD)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(WORLD)], out


# ------------------------------------------------ the ops, on threads
# (kernel, stride, padding, groups, the input's rows per /32 row): each
# convolution shape of the model (tests/test_torch_spatial.py)
CONVS = {"patch7s4": (7, 4, 3, 1, 32), "patch3s2": (3, 2, 1, 1, 8),
         "conv3": (3, 1, 1, 1, 1), "dwconv3": (3, 1, 1, 8, 2),
         "sr8": (8, 8, 0, 1, 8)}
# (image rows, sp): 2 and 1 rows at /32; 2, 1 and 1
GROUPS = ((96, 2), (128, 3))
BF16_ULP = 2.0 ** -7  # of a value in [1, 2)


def _sharded_grads(op, x, params, height, sp, seed=0):
    """The gradients of ``op`` at ``x`` (a level of an image ``height``
    rows tall) for one random cotangent: the whole op's (input, params),
    and on an sp group of threads each rank's input gradient joined in
    rank order and the ranks' parameter gradients summed."""
    x = x.detach().requires_grad_()
    y = op(x)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(seed)
                    ).to(y.dtype)
    whole = torch.autograd.grad(y, [x, *params], g)

    def rank(shard):
        xr = x.detach()[:, shard.rows(x.shape[1])].requires_grad_()
        return torch.autograd.grad(op(xr), [xr, *params],
                                   g[:, shard.rows(g.shape[1])])

    got = on_threads(rank, height, sp, grad=True)
    return whole, (torch.cat([r[0] for r in got], 1),
                   *(sum(r[i] for r in got) for i in range(1, len(whole))))


def _check_grads(whole, got, what):
    gx, want = got[0].float(), whole[0].float()
    assert gx.shape == want.shape, what
    if whole[0].dtype == torch.bfloat16:
        # 2 ulps of the largest gradient of each (sample, channel) plane:
        # each rank's terms are rounded to bf16 before their sum, and the
        # bicubic adjoint rounds between its two passes, so where the
        # terms cancel an element's own ulp is no scale (the whole op is
        # itself 1.06-1.24 such ulps from its fp32 gradient here)
        top = want.abs().amax(dim=(1, 2), keepdim=True)
        ulp = BF16_ULP * 2.0 ** torch.floor(torch.log2(top.clamp_min(
            1e-30)))
        assert ((gx - want).abs() <= 2 * ulp).all(), (
            what, float(((gx - want).abs() / ulp).max()))
    else:
        torch.testing.assert_close(gx, want, rtol=1e-5, atol=1e-6,
                                   msg=lambda m: f"{what}: {m}")
    for g, w in zip(got[1:], whole[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()),
                                   msg=lambda m: f"{what} (param): {m}")


def _ops():
    """name -> (op, input maker (rows at this level, dtype), params)."""
    torch.manual_seed(0)
    out = {}
    for name, (kh, stride, pad, groups, level) in CONVS.items():
        layer = Conv2d(8, 8, kh, stride, pad, groups=groups, bias=True)
        out[name] = (layer, level, 24, 8, list(layer.parameters()))
    out["bicubic"] = (upsample_rows_x2, 1, 12, 5, [])
    scale = torch.randn(32).requires_grad_()
    bias = torch.randn(32).requires_grad_()
    out["group_norm"] = (lambda t: group_norm(t, scale, bias, 4), 2, 12, 32,
                         [scale, bias])
    # each rank's tokens and queries against the keys, which every rank
    # holds whole; the token mean's sum crosses the ranks
    k = torch.randn(2, 5, 32).requires_grad_()
    wq = torch.randn(32, 32) / 6

    def attention(t):
        tok = t.reshape(2, -1, 32)
        return maxpool_attention(tok, tok @ wq, k, 2, 0.25).reshape(t.shape)

    out["token_mean"] = (attention, 2, 12, 32, [k])
    # the gathered map, used whole by each rank's own rows: output row i
    # mixes every row j by mix[i, j]
    mix = torch.randn(8, 8)

    def gathered(t):
        whole = spatial.all_gather_rows(t)
        shard = spatial.active()
        rows = slice(None) if shard is None else shard.rows(whole.shape[1])
        n = whole.shape[1]
        return torch.einsum("ij,bjwc->biwc", mix[:n, :n][rows], whole)

    out["all_gather_rows"] = (gathered, 2, 12, 8, [])
    return out


OPS = list(CONVS) + ["bicubic", "bicubic-bf16", "group_norm", "token_mean",
                     "all_gather_rows"]


@pytest.mark.parametrize("name", OPS)
def test_sharded_backward_equals_the_whole_ops_rows(name):
    op, level, width, ch, params = _ops()[name.removesuffix("-bf16")]
    dtype = torch.bfloat16 if name.endswith("-bf16") else torch.float32
    for height, sp in GROUPS:
        rows = height // spatial.ROW_UNIT * level
        x = (torch.randn(2, rows, width, ch) * 3 + 1).to(dtype)
        whole, got = _sharded_grads(op, x, params, height, sp)
        _check_grads(whole, got, (name, height, sp))


def test_a_dropped_halo_gradient_fails_the_check(monkeypatch):
    """The halo's backward without the gradient that the neighbours hand
    back: the 3x3 conv's input gradient at the cut misses the limit."""
    def own_rows_only(ctx, grad):
        _, _, _, _, n_top, h = ctx.plan
        return grad[:, n_top:n_top + h].clone(), None, None, None

    monkeypatch.setattr(spatial._Halo, "backward", staticmethod(
        own_rows_only))
    op, level, width, ch, params = _ops()["conv3"]
    whole, got = _sharded_grads(op, torch.randn(2, 3 * level, width, ch),
                                params, 96, 2)
    with pytest.raises(AssertionError):
        _check_grads(whole, got, "dropped halo")


def _block_grads(remat_fn, fresh_thread):
    """The input and parameter gradients of a stage-2 encoder block
    (drop path on, its mask from a seeded generator) on each rank of an
    sp = 2 group of threads over a 96-row image, run through
    ``remat_fn``, the backward on the rank's thread or on a new one."""
    torch.manual_seed(2)
    blocks = [Block(32, 2, 2, 4, drop_path=0.3).train()]
    blocks.append(copy.deepcopy(blocks[0]))  # one per rank, alike
    x = torch.randn(2, 96 // 8, 8, 32)

    def rank(shard):
        blk = blocks[shard.index]
        gen = torch.Generator().manual_seed(5)
        for m in blk.modules():
            if isinstance(m, layers.DropPath):
                m.generator = gen
        xr = x[:, shard.rows(12)].reshape(2, -1, 32).requires_grad_()
        y = remat_fn(blk, xr, (xr.shape[1] // 8, 8))
        params = list(blk.parameters())
        out = {}

        def backward():
            # OpenMP's thread count is per thread (tests/spatial_port.py)
            torch.set_num_threads(1)
            try:
                out["g"] = torch.autograd.grad(y.square().sum(),
                                               [xr, *params])
            except Exception as e:  # noqa: BLE001 (returned to the caller)
                out["g"] = e

        if fresh_thread:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        else:
            backward()
        return out["g"]

    return on_threads(rank, 96, 2, grad=True)


def _remat_without_the_shard(module, *args):
    """``remat`` as it was before it captured the shard."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(module, *args, use_reentrant=False)


def test_remat_backward_on_a_fresh_thread_equals_the_calling_thread():
    want = _block_grads(layers.remat, fresh_thread=False)
    got = _block_grads(layers.remat, fresh_thread=True)
    for r, (g, w) in enumerate(zip(got, want)):
        assert all(torch.equal(a, b) for a, b in zip(g, w)), (r, g)
    # without the captured shard the fresh thread's recompute runs on the
    # rank's rows as if they were the whole image (no halo, zero rows at
    # the cut): checkpoint finds the recomputed tensors' shapes changed
    bad = _block_grads(_remat_without_the_shard, fresh_thread=True)
    assert all(isinstance(g, RuntimeError) and "recomputed" in str(g)
               for g in bad), bad


# ------------------------------------------------ no processes: refusals
# the refusal of each layout that the JAX trainer refuses, and the cause
# both name: (flags, --set overrides, cause)
REFUSALS = {
    "sp3": (["--spatial-parallel", "3"], [],
            "spatial_parallel > 2 in training produces wrong conv "
            "gradients"),
    "with_data": (["--spatial-parallel", "2", "--data-parallel", "2"], [],
                  "spatial_parallel cannot be combined with data/fsdp axes "
                  "in training"),
    "height": (["--spatial-parallel", "2"],
               ["model.img_size=65,64", "data.image_dimension=65,64"],
               "image height 65 is not divisible by spatial_parallel=2"),
    "wire": (["--spatial-parallel", "2", "--wire", "on"], [],
             "data.wire_format=on requires a single-process run without "
             "sp sharding"),
}


@functools.lru_cache(maxsize=None)
def _jax_refusal(flags, overrides):
    """The JAX trainer's refusal of the same layout on the 8 virtual CPU
    devices: ``_auto_mesh``'s, else the Trainer's wire check (once for
    each case; train and distill share it)."""
    from camradepth_tpu.config import apply_overrides
    from camradepth_tpu.train.trainer import Trainer, _auto_mesh

    sp = int(flags[flags.index("--spatial-parallel") + 1])
    data = (int(flags[flags.index("--data-parallel") + 1])
            if "--data-parallel" in flags else -1)
    cfg = apply_overrides(jax_tiny_config(), list(overrides))
    cfg = cfg.replace(mesh=JaxMeshConfig(data_parallel=data,
                                         spatial_parallel=sp))
    if "--wire" in flags:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                   wire_format="on"))
    with pytest.raises(JaxConfigError) as e:
        _auto_mesh(cfg)
        Trainer(cfg, loaders={"train": [None]})
    return str(e.value)


@pytest.mark.parametrize("case", list(REFUSALS))
@pytest.mark.parametrize("command", ["train", "distill"])
def test_spatial_parallel_refusals_name_jax_causes(command, case, inputs,
                                                   monkeypatch, tmp_path,
                                                   capsys):
    """Each refusal as a two-rank group sees it, before anything is built
    (the process group's size patched to 2)."""
    flags, overrides, cause = REFUSALS[case]
    assert cause.lower() in _jax_refusal(tuple(flags),
                                         tuple(overrides)).lower()
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    extra = (["--teacher-checkpoint", str(tmp_path / "t.pth")]
             if command == "distill" else [])
    argv = [command, "--run-dir", str(tmp_path / "run")] + inputs[0] + \
        flags + extra + [a for kv in overrides for a in ("--set", kv)]
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and cause in err, err


# ------------------------------------------------ the two ranks
@pytest.mark.parametrize("run", ["base", "seg_tpu", "distill"])
def test_sp2_step_equals_the_single_process_step(ranks, run):
    for report in ranks[0]:
        r = report[run]
        print({k: v for k, v in r.items() if k != "metrics"})
        for key, limit in STEP_LIMITS.items():
            assert r[key] <= limit, (run, key, r[key], r.get("grad_worst"))


@pytest.mark.parametrize("run", ["seg_tpu", "distill"])
def test_no_guidance_pixel_lies_near_a_tie(ranks, run):
    """The seg steps' seed: every guidance pixel's top-2 gap exceeds twice
    its sharded-vs-single logit difference, so both runs take the same
    argmax maps."""
    for report in ranks[0]:
        margin, maps = report[f"{run}_ties"]
        assert maps >= 8 and margin > 0, (run, margin, maps)


def test_the_ranks_hold_uneven_rows_and_uneven_valid_gt():
    cfg = gc.check_config(hw=HW)
    counts = spatial.partition(HW[0], WORLD)
    assert counts == (2, 1)
    for micro in gc.parity_microbatches(cfg, 2, 2, seed=7, ranks=WORLD,
                                        image_rows=True):
        gt = micro["gt_depth"]
        assert np.mean(gt[:, :64] > 0) > 0.5 and np.mean(gt[:, 64:] > 0) < 0.1


def test_ranks_report_the_same_metrics_bit_for_bit(ranks):
    first, second = ranks[0]
    for run in ("base", "seg_tpu", "distill"):
        assert first[run]["metrics"] == second[run]["metrics"], run
        assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                   for m in first[run]["metrics"]), run
    assert first["jax_loss"] == second["jax_loss"]


def test_grad_parity_holds_for_sp2(ranks):
    for report in ranks[0]:
        r = report["grad_parity"]
        assert r["ok"] and not r["bad_leaves"], r
        assert r["max_rel_diff"] <= 1e-5 and r["loss_diff"] <= 1e-6, r


def test_sp2_gradients_match_jax(ranks, inputs):
    loss, grads = inputs[1].result()
    want = state_dict_from_flax(jax.device_get(grads))
    got = dict(np.load(ranks[1] / "jax_grads.npz"))
    assert sorted(got) == sorted(want)
    assert abs(ranks[0][0]["jax_loss"] - float(loss)) <= 1e-5 * float(loss)
    worst = max((_rel_l2(got[k], want[k]), k) for k in want)
    print("worst gradient, relative L2", worst)
    assert worst[0] <= 1e-4, worst


def _best_val_loss(run):
    return min(json.loads(line)["value"] for line in
               (run / "metrics.jsonl").read_text().splitlines()
               if json.loads(line)["tag"] == "val/loss")


def test_cli_train_sp2_equals_single_process(ranks, single_cli):
    reports, out = ranks
    assert [r["cli_rc"] for r in reports] == [0, 0]
    run = out / "run"
    ckpts = sorted(run.glob("ckpt_*"))
    want_ckpt = sorted(single_cli.glob("ckpt_*"))
    assert len(ckpts) == 1 and len(want_ckpt) == 1, (ckpts, want_ckpt)
    got_loss, want_loss = _best_val_loss(run), _best_val_loss(single_cli)
    assert abs(got_loss - want_loss) <= 1e-6 * abs(want_loss), (
        got_loss, want_loss)
    got = ckpt_util.restore_checkpoint(ckpts[0])["state_dict"]
    want = ckpt_util.restore_checkpoint(want_ckpt[0])["state_dict"]
    assert sorted(got) == sorted(want)
    keys = sorted(want)
    assert _rel_l2(np.concatenate([got[k].numpy().ravel() for k in keys]),
                   np.concatenate([want[k].numpy().ravel() for k in keys])
                   ) <= 1e-5
