"""The port's hyperparameter search (``train/search.py``, ``cli search``)
against the JAX package's, and the kernels' vmap rules, on the CPU.

- ``sample_config``, ``random_search`` and ``successive_halving_search``
  with a stub trial runner give the JAX package's results lists.
- The vmapped trial step: the JAX tests' two-conv toy model and its torch
  twin (``tests/_torch_search_child.ToyDepth``) on JAX's initial weights,
  JAX's ``_vmapped_machinery`` ``v_step``/``v_val`` against the port's at
  T = 4 trials, 2 microbatches, one step: each trial's loss and val loss
  rtol 1e-5, the parameters within the fp32 step limit of ``PERF.md`` §2
  (at most 0.1 % of the elements past 1e-3 * scale, none past 2 * scale,
  scale = the trial's lr * shape(step)). Whole ``vmapped_trials`` and
  ``vmapped_halving`` runs give JAX's rungs, step counts and survivors,
  each compared ranking gap asserted above 1 % first (diffGrad's sign-like
  update amplifies roundoff over steps).
- The port's vmapped step of tiny ``base`` and of tiny ``sup_unsup_seg`` +
  ``tpu_decoder`` (dropout on) against T unvmapped ``torch.func`` steps of
  the same model: loss rtol 1e-5, the parameters within the same limit.
  (The model and losses are held to JAX by ``tests/test_torch_train.py``.)
- Each kernel operator's vmap rule against a loop of unbatched calls:
  fp32 rtol 1e-6, bf16 bit for bit.
- Two gloo ranks (``tests/_torch_search_child.py``, forked by
  ``tests/torch_ranks.py`` with the module): the trial axis sharded, the
  halving rungs sharded and replicated, and ``cli search --data-parallel
  2``, each against the single-process run, rtol 1e-5 at one step.
- ``cli search`` wiring (as ``tests/test_search_profiling.py``), its
  refusals, and one real ``--vmap-trials --device cpu`` run.
"""

import concurrent.futures
import dataclasses
import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call, grad_and_value

from camradepth_tpu.config import tiny_test_config as jax_tiny
from camradepth_tpu.train import search as jax_search
from camradepth_tpu_torch import cli
from camradepth_tpu_torch.config import ConfigError, tiny_test_config
from camradepth_tpu_torch.data import synthetic
from camradepth_tpu_torch.models.camradepth import create_model
from camradepth_tpu_torch.ops import attention, gelu, resize
from camradepth_tpu_torch.train import search
from camradepth_tpu_torch.train.diffgrad import (
    diffgrad_direction,
    diffgrad_step_size,
)
from camradepth_tpu_torch.train.losses import multitask_loss
from camradepth_tpu_torch.train.schedule import onecycle
from camradepth_tpu_torch.train.step import build_gt
from tests import torch_ranks
from tests._torch_search_child import CLI_ARGS, TINY, ToyDepth, toy_batches
from tests import test_search_profiling as jax_search_tests
from tests.torch_port import one_torch_thread  # noqa: F401

CHILD = "tests._torch_search_child"
WORLD = 2
ALL_MODES = {"learning_rate": ([1e-5, 1e-3], "log"),
             "batch_size": ([1, 3], "int"),
             "pct_start": ([0.05, 0.3], "float"),
             "model.drop_path_rate": ([0.0, 0.1, 0.2], "item"),
             "weight_decay": ([0.0, 1e-2], "log"),  # skipped: lo <= 0
             "eps": ([1e-8, 1e-6], "unknown")}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


TOY_SPACES = {"learning_rate": ([1e-3, 1e-1], "log"),
              "weight_decay": ([1e-6, 1e-3], "log")}
TOY_TOTAL = 3


def _toy_lrs_wds():
    rng = np.random.default_rng(11)
    lrs = np.exp(rng.uniform(np.log(1e-4), np.log(1e-2), 4))
    wds = np.exp(rng.uniform(np.log(1e-6), np.log(1e-3), 4))
    return lrs.astype(np.float32), wds.astype(np.float32)


def _jax_toy_references():
    """Every JAX result of the toy tests: the toy's initial parameters as
    the JAX sweep draws them, one vmapped step and its val losses, and
    whole vmapped_trials / vmapped_halving runs (their rankings clear at
    every compared cut for this seed)."""
    jcfg = jax_tiny()
    jtoy = jax_search_tests.TestVmappedTrials._ToyDepth()
    h, w = jcfg.model.img_size
    params0 = jax.jit(lambda k: jtoy.init(
        {"params": k}, jnp.zeros((1, h, w, 7)), deterministic=True)[
            "params"])(jax.random.PRNGKey(jcfg.train.seed))
    batches = toy_batches(2)
    jv_step, jv_val, jmake = jax_search._vmapped_machinery(jcfg, jtoy,
                                                           TOY_TOTAL)
    jp, jo = jmake(4, jax.random.PRNGKey(jcfg.train.seed))
    lrs, wds = _toy_lrs_wds()
    jp1, _, jloss = jv_step(jp, jo, jnp.asarray(lrs), jnp.asarray(wds),
                            jax.tree.map(jnp.asarray, batches[0]),
                            jax.random.PRNGKey(0), jnp.int32(0))
    val = jax.tree.map(lambda a: jnp.asarray(a.reshape((-1,) + a.shape[2:])),
                       batches[1])
    out = {"params0": jax.tree.map(np.asarray, params0),
           "step": (jax.tree.map(np.asarray, jp1), np.asarray(jloss),
                    np.asarray(jv_val(jp1, val)))}
    out["trials"] = jax_search.vmapped_trials(
        jcfg, TOY_SPACES, num_trials=4, num_steps=3, seed=6,
        batches=batches, model=jtoy)
    out["halving"] = jax_search.vmapped_halving(
        jcfg, TOY_SPACES, num_trials=4, min_steps=1, max_steps=4, eta=2,
        seed=6, batches=batches, model=jtoy)
    return out


@pytest.fixture(scope="module", autouse=True)
def jax_toy():
    """The JAX toy references, computed on a thread of their own from the
    module's start (XLA leaves the interpreter lock while it compiles and
    runs), while the tests that need no JAX toy run."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_toy_references)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    return synthetic.generate(d, num_frames=6, hw=(32, 64), seed=1)


@pytest.fixture(scope="module", autouse=True)
def spawned(corpus, tmp_path_factory):
    """The two ranks, started with the module: the tests that need no
    process run while they work."""
    out = tmp_path_factory.mktemp("ranks")
    proc = torch_ranks.start(CHILD, WORLD, _free_port(), _free_port(),
                             corpus, out)
    try:
        yield proc, out
    finally:
        torch_ranks.stop(proc)


@pytest.fixture(scope="module")
def ranks(spawned):
    proc, out = spawned
    torch_ranks.wait(proc, WORLD)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(WORLD)]


# ------------------------------------------------------ sampling, sequential


def test_sample_config_matches_jax():
    for seed in range(5):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(4):
            got = search.sample_config(ALL_MODES, a)
            assert got == jax_search.sample_config(ALL_MODES, b)
        assert "weight_decay" not in got and "eps" not in got


def test_apply_overrides_routes_trees():
    cfg = search.apply_overrides(tiny_test_config(), {
        "learning_rate": 1e-4, "batch_size": 2, "desired_batch_size": 2,
        "model.drop_path_rate": 0.2, "data.num_workers": 3})
    assert cfg.train.learning_rate == 1e-4
    assert cfg.model.drop_path_rate == 0.2
    assert cfg.data.num_workers == 3


def _stub(c):
    return abs(c.train.learning_rate - 3e-4) + 1e-3 * (c.train.num_steps or 0)


def test_random_search_matches_jax_with_a_stub_runner():
    spaces = {"learning_rate": ([1e-5, 1e-3], "log")}
    got = search.random_search(tiny_test_config(), spaces, num_trials=8,
                               seed=1, trial_runner=_stub)
    assert got == jax_search.random_search(jax_tiny(), spaces, num_trials=8,
                                           seed=1, trial_runner=_stub)


def test_successive_halving_matches_jax_with_a_stub_runner():
    spaces = {"learning_rate": ([1e-5, 1e-3], "log"),
              "pct_start": ([0.05, 0.3], "float")}
    spent = []

    def runner(c):
        spent.append(c.train.num_steps)
        assert c.train.num_epochs is None
        return _stub(c)

    kw = dict(num_trials=9, min_steps=10, max_steps=90, eta=3, seed=1,
              trial_runner=runner)
    got = search.successive_halving_search(tiny_test_config(), spaces, **kw)
    assert got == jax_search.successive_halving_search(jax_tiny(), spaces,
                                                       **kw)
    assert sum(spent) == 2 * (9 * 10 + 3 * 30 + 1 * 90)
    assert len(got[2]) == 13


def test_vmap_spaces_and_batches_match_jax():
    spaces = {"batch_size": ([1, 3], "int")}
    with pytest.raises(ValueError) as want:
        jax_search._check_vmap_spaces(spaces)
    with pytest.raises(ValueError) as got:
        search._check_vmap_spaces(spaces)
    assert str(got.value) == str(want.value)
    rng = np.random.default_rng(0)

    def mb(i):
        return {"features": np.full((2, 4, 8, 7), float(i), np.float32),
                "gt_depth": rng.random((2, 4, 8)).astype(np.float32),
                "valid": np.ones((2,), np.float32)}  # dropped

    loaders = {"train": [mb(i) for i in range(5)], "val": [mb(99)]}
    got = search._resolve_batches(None, None, loaders, 2)
    want = jax_search._resolve_batches(None, None, loaders, 2)
    assert len(got[0]) == len(want[0]) == 2
    for a, b in zip(got[0] + [got[1]], want[0] + [want[1]]):
        assert sorted(a) == sorted(b) == ["features", "gt_depth"]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for fn in (search._resolve_batches, jax_search._resolve_batches):
        with pytest.raises(ValueError, match="train split too small"):
            fn(None, None, {"train": [mb(0)], "val": None}, 2)


def test_remat_is_refused_under_torch_func():
    cfg = tiny_test_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                remat_decoder=True))
    with pytest.raises(ConfigError, match="torch.utils.checkpoint"):
        search.vmapped_trials(cfg, {"learning_rate": ([1e-4, 1e-3], "log")},
                              batches=[{}], device="cpu")


# ------------------------------------------------------------- vmap rules


def _vmapped_vs_loop(fn, *args, in_dims=0):
    """fn under torch.func.vmap over the leading trial axis, and a loop of
    unbatched calls, stacked."""
    dims = in_dims if isinstance(in_dims, tuple) else (in_dims,) * len(args)
    got = torch.func.vmap(fn, in_dims=dims)(*args)
    outs = [fn(*(a if d is None else a[t] for a, d in zip(args, dims)))
            for t in range(args[0].shape[0])]
    if isinstance(got, tuple):
        return got, tuple(torch.stack(o) for o in zip(*outs))
    return (got,), (torch.stack(outs),)


def _check(got, want, exact):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        if exact or not a.is_floating_point():
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vmap_rules_match_a_loop_of_calls(dtype):
    g = torch.Generator().manual_seed(0)
    t, b, n, m, c, heads = 3, 2, 40, 10, 16, 2
    q = torch.randn(t, b, n, c, generator=g).to(dtype)
    k = torch.randn(t, b, m, c, generator=g).to(dtype)
    cot = torch.randn(t, b, n, generator=g)
    scale = (c // heads) ** -0.5
    exact = dtype == torch.bfloat16
    _check(*_vmapped_vs_loop(
        lambda a, b_: attention.scores_op(a, b_, heads, scale), q, k), exact)
    # k shared by the trials (its in_dim None): expanded, not folded twice
    _check(*_vmapped_vs_loop(
        lambda a, b_: attention.scores_op(a, b_, heads, scale), q, k[0],
        in_dims=(0, None)), exact)
    fwd = _vmapped_vs_loop(
        lambda a, b_: attention.maxpool_attention_scores_with_argmax(
            a, b_, heads, scale), q, k)
    _check(*fwd, exact)
    amax = fwd[0][1]
    _check(*_vmapped_vs_loop(
        lambda a, b_, i, gg: attention.maxpool_attention_scores_backward(
            a, b_, i, gg, heads, scale), q, k, amax, cot), exact)
    x = torch.randn(t, b, 5, 7, 6, generator=g).to(dtype)
    _check(*_vmapped_vs_loop(resize.upsample_bicubic_x2, x), exact)
    gy = torch.randn(t, b, 10, 14, 6, generator=g).to(dtype)
    _check(*_vmapped_vs_loop(resize.upsample_bicubic_x2_backward, gy), exact)
    if dtype == torch.bfloat16:
        xg = (torch.randn(t, b, 9, 5, generator=g) * 3).to(dtype)
        gg = torch.randn(t, b, 9, 5, generator=g).to(dtype)
        _check(*_vmapped_vs_loop(gelu.gelu_bf16, xg), True)
        _check(*_vmapped_vs_loop(gelu.gelu_bf16_backward, xg, gg), True)
        # the trial axis in another place than first
        _check(*_vmapped_vs_loop(gelu.gelu_bf16_backward,
                                 xg.movedim(0, 2).contiguous().movedim(2, 0),
                                 gg[0], in_dims=(0, None)), True)


def test_kernels_differentiate_under_vmap_of_grad():
    """vmap(grad) through the three autograd Functions of the kernels
    equals a loop of autograd backward passes, bit for bit in bf16."""
    g = torch.Generator().manual_seed(1)
    t = 3
    q = torch.randn(t, 2, 24, 8, generator=g).bfloat16()
    k = torch.randn(t, 2, 6, 8, generator=g).bfloat16()
    x = torch.randn(t, 2, 3, 5, 4, generator=g).bfloat16()

    def f(q, k, x):
        s = attention.maxpool_attention_scores(q, k, 2, 0.5)
        u = gelu.gelu_bf16(resize.upsample_bicubic_x2(x))
        return (s * s).sum() + (u.float() * u.float()).sum()

    got = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)))(q, k, x)
    for i in range(t):
        leaves = [a[i].clone().requires_grad_() for a in (q, k, x)]
        f(*leaves).backward()
        for a, leaf in zip(got, leaves):
            assert torch.equal(a[i], leaf.grad)


# ------------------------------------- the model's vmapped step, unvmapped


def _unvmapped_step(model, cfg, params, lr, wd, micro, seeds, step_i,
                    total):
    """One trial's step as the JAX sweep takes it, with torch.func.grad
    and no vmap: the reference of the vmapped step."""
    tr = cfg.train

    def loss_fn(p, mb):
        pred = functional_call(model, p, (mb["features"],))
        return multitask_loss(pred, build_gt(mb), cfg)[0]

    model.train()
    grads, losses = None, []
    for j, seed in enumerate(seeds):
        model.set_generator(torch.Generator().manual_seed(seed))
        g, loss = grad_and_value(loss_fn)(params, {k: v[j] for k, v in
                                                   micro.items()})
        grads = g if grads is None else {n: grads[n] + g[n] for n in g}
        losses.append(loss)
    accum = len(seeds)
    scale = lr * onecycle(1.0, total, tr.pct_start, tr.div_factor,
                          tr.final_div_factor)(step_i)
    step_size = diffgrad_step_size(1.0, *tr.betas)
    out = {}
    for n, p in params.items():
        g = grads[n] / accum + wd * p
        zero = torch.zeros_like(p)
        d = diffgrad_direction(g, torch.linalg.vector_norm(g), zero, zero,
                               zero, torch.zeros(()), step_size,
                               *tr.betas, tr.eps)[0]
        out[n] = p - scale * d
    return out, sum(losses[1:], losses[0]) / accum, scale


@pytest.mark.parametrize("variant", ["base", "sup_unsup_seg_tpu_decoder"])
def test_vmapped_model_step_matches_unvmapped_steps(variant):
    cfg = tiny_test_config()
    kw = dict(img_size=(32, 64))
    if variant != "base":
        kw.update(supervised_seg=True, unsupervised_seg=True,
                  tpu_decoder=True)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **kw))
    rng = np.random.default_rng(21)
    micro = {"features": rng.standard_normal((1, 2, 32, 64, 7)).astype(
        np.float32), "gt_depth": (rng.random((1, 2, 32, 64)) * (
            rng.random((1, 2, 32, 64)) < 0.3)).astype(np.float32)}
    if variant != "base":
        micro["seg"] = rng.integers(0, cfg.model.num_classes,
                                    (1, 2, 32, 64)).astype(np.int64)
        micro["seg_inter"] = micro["seg"][:, :, ::2, ::2].copy()
    micro = search._device_tree(micro, "cpu")
    model = create_model(cfg.model, device="cpu", seed=0, train=True)
    assert cfg.model.dropout_rate > 0  # the trials share the masks
    v_step, _, make_state = search._vmapped_machinery(
        cfg, model, 3, torch.device("cpu"))
    trials = 3
    lrs = torch.tensor([1e-4, 1e-3, 5e-3])
    wds = torch.tensor([0.0, 1e-4, 1e-2])
    params, opt = make_state(trials)
    seeds = (5,)  # one microbatch (the toy step above accumulates two)
    new, _, losses = v_step(params, opt, lrs, wds, micro, [
        torch.Generator().manual_seed(s) for s in seeds], 0)
    for t in range(trials):
        want, loss, scale = _unvmapped_step(
            model, cfg, {n: p[t] for n, p in params.items()},
            float(lrs[t]), float(wds[t]), micro, seeds, 0, 3)
        np.testing.assert_allclose(losses[t].item(), loss.item(), rtol=1e-5)
        _step_limit(torch.cat([new[n][t].ravel() for n in want]).numpy(),
                    torch.cat([want[n].ravel() for n in want]).numpy(),
                    scale)


# --------------------------------------------------------------- the CLI


def _fake_result(steps):
    return ({"learning_rate": 1e-4}, 0.5,
            [{"overrides": {"learning_rate": 1e-4}, "val_loss": 0.5,
              "steps": steps}])


def test_cli_search_wiring(monkeypatch, capsys):
    """The flags reach the search functions as the JAX CLI routes them."""
    seen = {}

    def fake_random(cfg, spaces, num_trials=0, seed=0, device=None):
        seen.update(cfg=cfg, spaces=spaces, num_trials=num_trials,
                    device=device)
        return _fake_result(cfg.train.num_steps)

    def fake_halving(cfg, spaces, num_trials=0, min_steps=0, max_steps=0,
                     seed=0, device=None):
        seen.update(spaces=spaces, min_steps=min_steps, max_steps=max_steps)
        return _fake_result(max_steps)

    def fake_vmapped(cfg, spaces, num_trials=0, seed=0, loaders=None,
                     shard_trials=False, device=None, **kw):
        batches, val = search._resolve_batches(None, None, loaders,
                                               cfg.train.update_interval)
        seen.update(cfg=cfg, batches=batches, val=val, shard=shard_trials,
                    **kw)
        return _fake_result(kw.get("num_steps", kw.get("max_steps")))

    monkeypatch.setattr(search, "random_search", fake_random)
    monkeypatch.setattr(search, "successive_halving_search", fake_halving)
    monkeypatch.setattr(search, "vmapped_trials", fake_vmapped)
    monkeypatch.setattr(search, "vmapped_halving", fake_vmapped)
    assert cli.main([
        "search", "--num-trials", "3", "--trial-steps", "7", "--space",
        '{"learning_rate": [[1e-5, 1e-3], "log"]}', "--device", "cpu"]) == 0
    assert seen["num_trials"] == 3 and seen["device"] == "cpu"
    assert seen["cfg"].train.num_steps == 7
    assert seen["cfg"].train.save_model is False
    assert seen["spaces"] == {"learning_rate": ((1e-5, 1e-3), "log")}
    out = capsys.readouterr().out
    assert out.splitlines()[0] == json.dumps(_fake_result(7)[2][0])
    assert "best config: " in out
    assert cli.main(["search", "--halving", "--min-steps", "3",
                     "--trial-steps", "27", "--device", "cpu"]) == 0
    assert (seen["min_steps"], seen["max_steps"]) == (3, 27)
    assert seen["spaces"] == cli._DEFAULT_SPACES

    from camradepth_tpu_torch.data import pipeline

    def fake_batch(i):
        return {"features": np.full((2, 8, 16, 7), float(i), np.float32),
                "gt_depth": np.ones((2, 8, 16), np.float32),
                "token": np.zeros((2,), np.int64)}  # must be dropped

    monkeypatch.setattr(pipeline, "make_loaders", lambda *a, **k: {
        "train": [fake_batch(i) for i in range(7)],
        "val": [fake_batch(99)]})
    assert cli.main(["search", "--vmap-trials", "--halving", "--num-trials",
                     "8", "--min-steps", "3", "--trial-steps", "27",
                     "--train-val-split", "5,2", "--device", "cpu"]) == 0
    assert (seen["min_steps"], seen["max_steps"]) == (3, 27)
    accum = seen["cfg"].train.update_interval
    assert seen["cfg"].data.train_val_split == (5, 2)
    assert len(seen["batches"]) == 7 // accum
    assert seen["batches"][0]["features"].shape == (accum, 2, 8, 16, 7)
    assert sorted(seen["batches"][0]) == ["features", "gt_depth"]
    assert seen["val"]["features"].shape == (2, 8, 16, 7)
    assert seen["shard"] is False


def test_cli_search_refusals(capsys):
    for argv, msg in (
            (["--data-parallel", "2"], "--vmap-trials"),
            (["--vmap-trials", "--data-parallel", "2"], "2 processes"),
            (["--vmap-trials", "--space",
              '{"batch_size": [[1, 3], "int"]}'], "hyperparameters"),
            (["--vmap-trials", "--set", "model.remat_encoder=true"],
             "torch.utils.checkpoint"),
            (["--space", "[1]"], "--space")):
        assert cli.main(["search", "--device", "cpu", "--split",
                         "missing.npy", *argv]) == 2, argv
        assert msg in capsys.readouterr().err, argv


def test_cli_search_vmap_trials_runs_and_matches_the_ranks(corpus, ranks,
                                                           capsys):
    """One real single-process ``--vmap-trials`` run at tiny widths; the
    two ranks' ``--data-parallel 2`` run of the same flags printed the
    same results (rank 0 alone prints)."""
    argv = CLI_ARGS + ["--split", str(corpus)] + [
        a for s in TINY for a in ("--set", s)]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    results = [json.loads(line) for line in lines[:-1]]
    assert len(results) == 4 and lines[-1].startswith("best config: ")
    vals = [r["val_loss"] for r in results]
    assert all(np.isfinite(vals)) and len(set(vals)) == 4
    best = results[int(np.argmin(vals))]["overrides"]
    assert lines[-1].startswith(f"best config: {json.dumps(best)}")
    assert [r["cli_rc"] for r in ranks] == [0, 0]
    assert ranks[1]["cli_out"] == ""
    sharded = [json.loads(line) for line in
               ranks[0]["cli_out"].strip().splitlines()[:-1]]
    assert [r["overrides"] for r in sharded] == [r["overrides"]
                                                 for r in results]
    np.testing.assert_allclose([r["val_loss"] for r in sharded], vals,
                               rtol=1e-5)
    # too few train frames for one optimizer step: rc 2, as JAX
    assert cli.main(argv[:argv.index("--train-val-split")] + [
        "--train-val-split", "1,2"] + argv[argv.index(
            "--train-val-split") + 2:]) == 2
    assert "train split too small" in capsys.readouterr().err


# ------------------------------------------------------------ gloo ranks


@pytest.mark.parametrize("run", ["trials", "halving_sharded",
                                 "halving_replicated"])
def test_trial_axis_over_ranks_matches_one_process(ranks, run):
    for r in ranks:
        got, want = np.array(r[run]["sharded"]), np.array(r[run]["single"])
        np.testing.assert_array_equal(got[:, [0, 2, 3]], want[:, [0, 2, 3]])
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-5)
    assert ranks[0][run] == ranks[1][run]
    rungs = [row[2] for row in ranks[0][run]["sharded"]]
    assert {"trials": [0] * 4, "halving_sharded": [0] * 4 + [1] * 2,
            "halving_replicated": [0] * 4 + [1]}[run] == rungs


# ------------------------------------------------ the toy step against JAX


def _step_limit(got, want, scale):
    diffs = np.abs(got - want)
    print(f"max {diffs.max() / scale:.3g} scale, "
          f"{np.mean(diffs > 1e-3 * scale):.3g} past 1e-3 scale")
    assert diffs.max() <= 2 * scale
    assert np.mean(diffs > 1e-3 * scale) <= 1e-3


def test_vmapped_toy_step_matches_jax(jax_toy):
    ref = jax_toy.result()
    jp1, jloss, jval = ref["step"]
    cfg, batches = tiny_test_config(), toy_batches(2)
    lrs, wds = _toy_lrs_wds()
    model = ToyDepth().load_flax(ref["params0"])
    v_step, v_val, make_state = search._vmapped_machinery(
        cfg, model, TOY_TOTAL, torch.device("cpu"))
    p, o = make_state(4)
    p1, o1, loss = v_step(p, o, torch.from_numpy(lrs), torch.from_numpy(wds),
                          search._device_tree(batches[0], "cpu"),
                          [None, None], 0)
    tval = v_val(p1, search._flat_val(search._device_tree(batches[1],
                                                          "cpu"))).numpy()
    np.testing.assert_allclose(loss.numpy(), jloss, rtol=1e-5)
    np.testing.assert_allclose(tval, jval, rtol=1e-5)
    assert len(set(np.round(jval, 6))) == 4  # the trials moved apart
    shape = onecycle(1.0, TOY_TOTAL, cfg.train.pct_start,
                     cfg.train.div_factor, cfg.train.final_div_factor)(0)
    for i in range(4):
        got = np.concatenate([
            p1[f"{n}.weight"][i].numpy().transpose(2, 3, 1, 0).ravel()
            for n in ("feat", "head")] + [
            p1[f"{n}.bias"][i].numpy() for n in ("feat", "head")])
        want = np.concatenate([jp1[n]["kernel"][i].ravel()
                               for n in ("feat", "head")] + [
            jp1[n]["bias"][i] for n in ("feat", "head")])
        _step_limit(got, want, lrs[i] * shape)


def _gap_above(vals, cut: int, share: float = 0.01) -> None:
    """The gap between the ``cut``-th and next best of ``vals`` exceeds
    ``share`` of their size: a ranking that roundoff cannot flip."""
    s = np.sort(np.asarray(vals))
    assert s[cut] - s[cut - 1] > share * abs(s[cut]), s


def test_vmapped_sweeps_match_jax(jax_toy):
    ref = jax_toy.result()
    cfg, batches = tiny_test_config(), toy_batches(2)
    want = ref["trials"]
    got = search.vmapped_trials(cfg, TOY_SPACES, num_trials=4, num_steps=3,
                                seed=6, batches=batches, device="cpu",
                                model=ToyDepth().load_flax(ref["params0"]))
    _gap_above([r["val_loss"] for r in want[2]], 1)
    assert got[0] == want[0]
    assert [(r["overrides"], r["steps"]) for r in got[2]] == [
        (r["overrides"], r["steps"]) for r in want[2]]
    np.testing.assert_allclose([r["val_loss"] for r in got[2]],
                               [r["val_loss"] for r in want[2]], rtol=1e-3)

    want = ref["halving"]
    got = search.vmapped_halving(cfg, TOY_SPACES, num_trials=4, min_steps=1,
                                 max_steps=4, eta=2, seed=6, batches=batches,
                                 device="cpu",
                                 model=ToyDepth().load_flax(ref["params0"]))
    rungs = sorted({r["rung"] for r in want[2]})
    for rung in rungs[:-1]:
        vals = [r["val_loss"] for r in want[2] if r["rung"] == rung]
        _gap_above(vals, -(-len(vals) // 2))
    assert [(r["overrides"], r["rung"], r["steps"]) for r in got[2]] == [
        (r["overrides"], r["rung"], r["steps"]) for r in want[2]]
    assert [r["steps"] for r in got[2]] == [1, 1, 1, 1, 2, 2, 4]
    assert got[0] is got[2][-1]["overrides"] and got[0] == want[0]
    np.testing.assert_allclose([r["val_loss"] for r in got[2]],
                               [r["val_loss"] for r in want[2]], rtol=1e-3)
