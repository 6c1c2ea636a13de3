"""Spatial parallel inference and mesh serving of the port
(camradepth_tpu_torch.parallel.spatial, parallel/mesh.ServingMesh,
DepthEngine(mesh=...), serving_http.MeshLeader, cli serve
--data-parallel/--spatial-parallel) on the CPU, against the port's
single-process forward and the JAX package's forward.

The module starts one gloo group of four processes
(``tests/_torch_spatial_child.py``, forked by ``tests/torch_ranks.py`` from
one process that imports their code once; one torch thread each at a lower
priority, tiny widths, fp32, 64x128: two rows at /32) when it starts,
compiles the JAX forwards on threads and runs its tests that need no
process meanwhile, then reads what each rank reports. Variants: ``base``
and ``sup_unsup_seg`` + ``tpu_decoder``, their parameters numpy-seeded
through the JAX modules' init trees and ``state_dict_from_flax`` (seeded
so that no guidance pixel lies near a tie: every guidance head's top-2
logit gap exceeds twice its largest difference, asserted first). Limits:

- the gathered outputs of sp = 2 and of data 2 x sp 2 against the port's
  single-process forward: the depth maps within rtol 1e-5, atol 1e-5, the
  JAX package's limit for its sharded engine (``tests/test_serving.py:
  290-315``); GroupNorm's and the token mean's fp32 sums run in another
  order across the ranks. The seg logits and the guidance heads' logits
  (magnitudes up to ~4 here) within rtol 1e-5 and atol 1e-5 times their
  largest magnitude: measured up to 1.17e-5 absolute (2.97e-6 of their
  largest), against 2.15e-6 at most on the depth maps;
- the same against the JAX package's forward: the whole-model limit, fp32
  1e-4 (``tests/test_torch_model.py``), the logits' atol scaled alike;
  argmax maps equal;
- each rank's calls of the three kernel wrappers per forward: the
  single-process forward's;
- ``cli serve --spatial-parallel 2`` and ``--data-parallel 2`` over a
  6-frame synthetic split: the maps within rtol 1e-5 and atol 1e-5 of
  those of single-process ``cli serve`` (depth in metres, 0..100 m: atol
  1e-3 m, a 1e-5 share of the range);
- an HTTP server on a data 2 x sp 2 mesh: each of 3 concurrent answers
  equals the engine's ``infer_batch`` of its frame bit for bit.

Without processes, the ranks of an sp group run as threads of this one
(``tests/spatial_port.py``): every op with a halo (the convolutions of each
shape the model has, the depthwise conv, the bicubic x2 in fp32 and bf16)
on a rank's rows plus their halo equals the same rows of the op on the
whole tensor bit for bit, at sp = 2, 3 and 4 with 1-row shards; the
sharded GroupNorm and token mean within fp32 1e-6 of the whole tensor's;
the partition, its limit, and the refusals of ``cli serve`` against the
JAX CLI's.
"""

import concurrent.futures
import json
import socket
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camradepth_tpu import cli as jax_cli
from camradepth_tpu.config import ModelConfig as JaxModelConfig
from camradepth_tpu.models.camradepth import CamRaDepth as JaxCamRaDepth
from camradepth_tpu_torch import cli
from camradepth_tpu_torch.config import (
    ConfigError,
    ModelConfig,
)
from camradepth_tpu_torch.data import synthetic
from camradepth_tpu_torch.interop.flax_convert import state_dict_from_flax
from camradepth_tpu_torch.models.camradepth import create_model
from camradepth_tpu_torch.models.layers import Conv2d, upsample_rows_x2
from camradepth_tpu_torch.ops.attention import maxpool_attention
from camradepth_tpu_torch.ops.groupnorm import group_norm
from camradepth_tpu_torch.parallel import multihost, spatial
from camradepth_tpu_torch.parallel.mesh import (
    ServingLayout,
    serving_layout,
    serving_mesh,
)
from tests import torch_ranks
from tests.spatial_port import count_calls, model_outputs, on_threads
from tests.test_torch_model import _assert_no_near_ties, _jax_init
from tests.torch_port import one_torch_thread  # noqa: F401

CHILD = "tests._torch_spatial_child"
WORLD = 4
HW = (64, 128)
SMALL = dict(
    img_size=HW, dims=(16, 32, 32, 64), heads=(1, 2, 4, 8),
    ff_expansion=(2, 2, 2, 2), sr_ratios=(8, 4, 2, 1), depths=(1, 1, 1, 1),
    mid_channels=32, input_channels=7, drop_path_rate=0.0,
    compute_dtype="float32",
)
VARIANTS = {"base": {},
            "seg_tpu": dict(supervised_seg=True, unsupervised_seg=True,
                            tpu_decoder=True)}
# the parameter seed of each variant: the seg variant's is the first from
# 1 at which every guidance pixel's top-2 logit gap exceeds 10 times its
# single-process port-vs-JAX logit difference (module docstring; a margin
# for the sharded sums)
SEEDS = {"base": 1, "seg_tpu": 11}
# the JAX forwards' compile: XLA's own passes, then no LLVM optimization.
# It takes ~40 % less CPU, which the suite's other workers share; its
# outputs differ from the optimized program's by ~1e-6 (measured: 9.9e-7
# and 7.2e-7 on the final depth), far inside the 1e-4 limit
JAX_COMPILE = {"xla_backend_optimization_level": 0}
SHARD_TOL = dict(rtol=1e-5, atol=1e-5)
# the depth maps; the other outputs are seg logits (and argmax maps)
DEPTH_KEYS = ("final", "inter3", "inter4")
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
TINY = ["--set", "model.img_size=64,128", "--set", "model.dims=16,32,32,64",
        "--set", "model.ff_expansion=2,2,2,2", "--set",
        "model.depths=1,1,1,1", "--set", "model.mid_channels=32", "--set",
        "data.image_dimension=64,128", "--set",
        "model.compute_dtype=float32"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _model_cfg(variant):
    return dict(SMALL, **VARIANTS[variant])


@pytest.fixture(scope="module")
def in_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("spatial_in")


@pytest.fixture(scope="module", autouse=True)
def spawned(in_dir, tmp_path_factory):
    """The four ranks, started with the module: they import and fork while
    ``inputs`` writes what they read (``spec.json`` last)."""
    out = tmp_path_factory.mktemp("spatial_out")
    proc = torch_ranks.start(CHILD, WORLD, in_dir, out,
                             *(_free_port() for _ in range(3)))
    try:
        yield proc, out
    finally:
        torch_ranks.stop(proc)


@pytest.fixture(scope="module", autouse=True)
def inputs(in_dir, spawned):
    """The variants' flax parameters, reference-layout weights and inputs,
    the corpus and the flags of the ranks' cli serve, written for the
    ranks."""
    d = in_dir
    params, xs = {}, {}
    for i, variant in enumerate(VARIANTS):
        xs[variant] = np.random.default_rng(40 + i).standard_normal(
            (2, *HW, 7), dtype=np.float32)
        jmodel = JaxCamRaDepth(JaxModelConfig(**_model_cfg(variant)))
        params[variant] = _jax_init(jmodel, jnp.asarray(xs[variant][:1]),
                                    seed=SEEDS[variant], deterministic=True)
        sd = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in state_dict_from_flax(params[variant]).items()}
        torch.save({"state_dict": sd}, d / f"{variant}.pth")
        np.save(d / f"{variant}_x.npy", xs[variant])
    split = synthetic.generate(d / "corpus", num_frames=6, hw=HW, seed=2)
    serve = ["--split", str(split), "--set", "data.mini_dataset=1",
             "--checkpoint", str(d / "base.pth"), "--device", "cpu",
             "--serve-batch", "2", "--set", "data.num_workers=1"] + TINY
    spec = d / "spec.json.tmp"
    spec.write_text(json.dumps({
        "models": {v: _model_cfg(v) for v in VARIANTS},
        "img_height": HW[0], "serve_flags": serve}))
    spec.rename(d / "spec.json")  # the ranks start on it
    return d, params, xs, serve


@pytest.fixture(scope="module", autouse=True)
def jax_forwards(inputs):
    """Each variant's JAX fp32 forward (its maps, and its guidance heads'
    logits), compiled on threads beside the ranks: a future each."""
    _, params, xs, _ = inputs
    heads = ("seg_conv_stage_4", "unsup_stage_4", "seg_conv_final",
             "unsup_final")

    def forward(variant):
        model = JaxCamRaDepth(JaxModelConfig(**_model_cfg(variant)))
        return jax.jit(lambda p, v: model.apply(
            {"params": p}, v,
            capture_intermediates=lambda mod, _: mod.name in heads))

    def run(variant):
        x = jnp.asarray(xs[variant])
        out, inter = forward(variant).lower(params[variant], x).compile(
            JAX_COMPILE)(params[variant], x)
        d = out["depth"]
        got = {"final": d["final_depth"],
               "inter3": d["intermediate_depths"][2],
               "inter4": d["intermediate_depths"][3]}
        got.update({k: v for k, v in out["seg"].items() if v is not None})
        got.update({f"head:{k}": v["__call__"][0] for k, v in
                    inter.get("intermediates", {}).items()})
        return {k: np.asarray(v, np.float32) for k, v in got.items()}

    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        yield {v: pool.submit(run, v) for v in VARIANTS}


@pytest.fixture(scope="module")
def single(inputs):
    """Each variant's single-process port forward and its wrapper calls."""
    d, _, xs, _ = inputs
    out = {}
    for variant in VARIANTS:
        model = create_model(ModelConfig(**_model_cfg(variant)), device="cpu",
                             state_dict=torch.load(d / f"{variant}.pth")
                             ["state_dict"])
        with count_calls() as calls, torch.no_grad():
            got = model_outputs(model, torch.from_numpy(xs[variant]))
        out[variant] = ({k: v.numpy() for k, v in got.items()}, dict(calls))
    return out


@pytest.fixture(scope="module")
def ranks(spawned):
    """Each rank's report and the gathered outputs of each run."""
    proc, out = spawned
    torch_ranks.wait(proc, WORLD)
    reports = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(WORLD)]
    runs = {f.stem: dict(np.load(f)) for f in out.glob("*.npz")}
    return reports, runs, out


# ------------------------------------------------ the ops, on threads
# (kernel, stride, padding, groups, the input's rows per /32 row): each
# convolution shape of the model (the stage-1 and later patch embeds, the
# 3x3 decoder and head convs, the depthwise 3x3, the stage-1 sr-conv)
CONVS = {"patch7s4": (7, 4, 3, 1, 32), "patch3s2": (3, 2, 1, 1, 8),
         "conv3": (3, 1, 1, 1, 1), "dwconv3": (3, 1, 1, 8, 2),
         "sr8": (8, 8, 0, 1, 8)}


def _whole_and_shards(op, x, sp):
    """``op`` on the whole tensor, and each rank's result of it on its
    rows under an sp group of threads."""
    with torch.no_grad():
        whole = op(x)
    # x is a level of an image of 4 rows at /32 (128 rows)
    got = on_threads(lambda shard: op(x[:, shard.rows(x.shape[1])]),
                     128, sp)
    return whole, got, spatial.partition(128, sp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("conv", list(CONVS))
def test_halo_conv_equals_the_whole_conv_rows(conv, dtype):
    kh, stride, pad, groups, level = CONVS[conv]
    torch.manual_seed(0)
    layer = Conv2d(8, 8, kh, stride, pad, groups=groups, bias=True)
    layer = layer.to(getattr(torch, dtype))
    x = torch.randn(2, 4 * level, 24, 8).to(getattr(torch, dtype))
    for sp in (2, 3, 4):
        whole, got, counts = _whole_and_shards(layer, x, sp)
        assert torch.cat(got, dim=1).shape == whole.shape
        start = 0
        for r, g in enumerate(got):
            rows = counts[r] * whole.shape[1] // 4
            assert torch.equal(g, whole[:, start:start + rows]), (sp, r)
            start += rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_halo_bicubic_equals_the_whole_upsample_rows(dtype):
    """At one row per /32 row (sp = 4: a rank owns one row, and its halo
    comes from two ranks away or the image's edge) and at two."""
    for level in (1, 2):
        x = torch.randn(2, 4 * level, 12, 5).to(getattr(torch, dtype))
        for sp in (2, 3, 4):
            whole, got, _ = _whole_and_shards(upsample_rows_x2, x, sp)
            assert torch.equal(torch.cat(got, dim=1), whole), (level, sp)


def test_sharded_group_norm_and_token_mean_match_the_whole_tensor():
    """GroupNorm's and the attention's token mean's fp32 sums, combined
    from each rank's rows, against the whole tensor's (each rank's
    queries against all keys)."""
    torch.manual_seed(1)
    x = torch.randn(2, 16, 12, 32) * 3 + 1
    scale, bias = torch.randn(32), torch.randn(32)
    q, k = torch.randn(2, 16, 12, 32), torch.randn(2, 5, 32)

    def gn(t):
        return group_norm(t, scale, bias, 4)

    def attention(rows):
        return maxpool_attention(x[:, rows].reshape(2, -1, 32),
                                 q[:, rows].reshape(2, -1, 32), k, 2, 0.25)

    for sp in (2, 3, 4):
        whole, got, _ = _whole_and_shards(gn, x, sp)
        torch.testing.assert_close(torch.cat(got, 1), whole, rtol=1e-6,
                                   atol=1e-6)
        with torch.no_grad():
            whole = attention(slice(None))
        got = on_threads(lambda shard: attention(shard.rows(16)), 128, sp)
        torch.testing.assert_close(torch.cat(got, 1), whole, rtol=1e-6,
                                   atol=1e-6)


def test_partition_and_its_limit():
    assert spatial.partition(416, 2) == (7, 6)
    assert spatial.partition(416, 4) == (4, 3, 3, 3)
    assert spatial.partition(416, 13) == (1,) * 13
    shard = spatial.RowShard((7, 6), 1)
    assert shard.rows(416) == slice(224, 416) and shard.rows(13) == slice(7,
                                                                          13)
    assert shard.factor(192) == 32 and shard.global_count(6 * 25) == 13 * 25
    with pytest.raises(ConfigError, match="at most 13"):
        spatial.partition(416, 16)
    with pytest.raises(ConfigError, match="multiple of 32"):
        spatial.partition(400, 2)
    # without a shard every helper is the identity
    x = torch.randn(1, 4, 3, 2)
    assert spatial.halo(x, 2, 2) == (x, 0, 0)
    assert spatial.all_gather_rows(x) is x
    assert torch.equal(spatial.sum_across(x), x)


def test_serving_layout_sizes_and_refusals(monkeypatch):
    """serving_layout makes every refusal before a process starts;
    serving_mesh then holds the layout to the process group."""
    assert serving_layout(1, 1, 416, 8) is None
    assert serving_layout(2, 2, 416, 8) == ServingLayout(2, 2)
    for args, kw, match in (
            ((2, 1, 416, 3), {}, "not divisible by --data-parallel 2"),
            ((1, 3, 416, 8), {}, "not divisible by --spatial-parallel 3"),
            ((1, 4, 64, 8), {}, "at most 2"),
            ((2, 1, 416, 8), dict(artifact=True), "artifact"),
            ((1, 2, 416, 8), dict(wire_format="on"), "wire_format=on")):
        with pytest.raises(ConfigError, match=match):
            serving_layout(*args, **kw)
    # wire with data only is allowed, as in JAX
    assert serving_layout(2, 1, 416, 8, wire_format="on") == ServingLayout(2)
    assert serving_mesh(None, 416) is None
    with pytest.raises(ConfigError, match="needs 4 ranks, have 1"):
        serving_mesh(ServingLayout(2, 2), 416)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    with pytest.raises(ConfigError, match="serving layout over all of them"):
        serving_mesh(None, 416)


@pytest.mark.parametrize("env, coordinator, world, ranks", [
    ({"LOCAL_WORLD_SIZE": "4"}, None, None, 4),
    ({"LOCAL_WORLD_SIZE": "2"}, "10.0.0.1:1234", 8, 2),
    ({}, "127.0.0.1:1234", 2, 2),
    ({}, "localhost:1234", 4, 4),
    ({}, "[::1]:1234", 2, 2),
    ({}, "10.0.0.1:1234", 8, 1)])
def test_ranks_on_this_host_pick_the_backend(monkeypatch, env, coordinator,
                                             world, ranks):
    """The ranks that initialize counts on this host: gloo on a card when
    they outnumber the cards (NCCL refuses two ranks on one card)."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert multihost._local_ranks(coordinator, world) == ranks


# the refusals of cli serve that the JAX CLI makes too, each before
# anything loads (camradepth_tpu/cli.py:679-723), and the text each
# names in both CLIs
JAX_REFUSALS = {
    "batch": (["--serve-batch", "3", "--data-parallel", "2"],
              "not divisible by --data-parallel 2"),
    "height": (["--spatial-parallel", "3"],
               "not divisible by --spatial-parallel 3"),
    "artifact": (["--spatial-parallel", "2"], "artifact"),
    "wire": (["--spatial-parallel", "2", "--wire", "on"],
             "data.wire_format=on is incompatible"),
}


@pytest.mark.parametrize("case", list(JAX_REFUSALS))
def test_cli_serve_refusals_match_jax(case, inputs, tmp_path, capsys):
    extra, match = JAX_REFUSALS[case]
    ckpt = str(inputs[0] / "base.pth")
    if case == "artifact":
        ckpt = str(tmp_path / "model.pt2")
        Path(ckpt).write_bytes(b"\0" * 8)
        jax_ckpt = tmp_path / "model.hlo"
        jax_ckpt.write_bytes(b"CRDSHLO1" + bytes(8))
    argv = ["serve", "--split", str(inputs[0] / "corpus" /
                                    "synthetic_split.npy")] + TINY + extra
    assert cli.main(argv + ["--checkpoint", ckpt, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and match in err, err
    jax_argv = argv + ["--checkpoint", str(jax_ckpt) if case == "artifact"
                       else ckpt]
    assert jax_cli.main(jax_argv) == 2
    assert match.lower() in capsys.readouterr().err.lower()


def test_cli_serve_refuses_sp_above_the_row_count(inputs, capsys):
    """The port's own limit: 64 rows hold 2 rows at /32 (JAX pads)."""
    rc = cli.main(["serve", "--checkpoint", str(inputs[0] / "base.pth"),
                   "--device", "cpu", "--spatial-parallel", "4"] + TINY)
    err = capsys.readouterr().err
    assert rc == 2 and "at most 2" in err, err


# ------------------------------------------------ the four ranks
def _close(got, want, tol, what):
    """Each output within ``tol``; a logit map's atol taken relative to its
    largest magnitude (module docstring)."""
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for key, w in want.items():
        assert got[key].shape == w.shape, (what, key)
        if key == "unsup_map":  # an argmax map
            np.testing.assert_array_equal(got[key], w, err_msg=key)
            continue
        scale = 1.0 if key in DEPTH_KEYS else max(1.0, np.abs(w).max())
        np.testing.assert_allclose(got[key], w, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale,
                                   err_msg=f"{what}: {key}")


def _heads(out):
    return {k.removeprefix("head:"): v for k, v in out.items()
            if k.startswith("head:")}


@pytest.mark.parametrize("layout", ["sp2", "mesh"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_forward_equals_the_single_process_forward(
        single, served_single, ranks, variant, layout):
    # (the single-process references are made while the ranks work)
    got = ranks[1][f"{layout}_{variant}"]
    _close(got, single[variant][0], SHARD_TOL, f"{layout} {variant}")


@pytest.mark.parametrize("layout", ["sp2", "mesh"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_forward_matches_jax(ranks, jax_forwards, variant, layout):
    got = ranks[1][f"{layout}_{variant}"]
    want = jax_forwards[variant].result()
    if variant != "base":
        cfg = ModelConfig(**_model_cfg(variant))
        _assert_no_near_ties(_heads(got), _heads(want), cfg)
        for key in ("final_seg", "intermediate_seg"):
            np.testing.assert_array_equal(got[key].argmax(-1),
                                          want[key].argmax(-1), err_msg=key)
    _close(got, want, JAX_TOL, f"{layout} {variant} vs JAX")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_each_rank_calls_the_kernels_as_one_process(ranks, single, variant):
    want = single[variant][1]
    assert want["attention"] == 4 and want["gelu"] == 0
    assert want["bicubic"] == (5 if variant == "base" else 3)
    reports = ranks[0]
    pair = [r for r in range(WORLD) if list(VARIANTS)[r // 2] == variant]
    for r in pair:
        assert reports[r]["sp2_calls"] == want, (r, reports[r]["sp2_calls"])
    for r in range(WORLD):
        assert reports[r][f"mesh_calls_{variant}"] == want, r


@pytest.fixture(scope="module")
def served_single(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("served_single")
    assert cli.main(["serve"] + inputs[3] + ["--out", str(out)]) == 0
    return out


@pytest.mark.parametrize("run", ["cli_sp2", "cli_dp2"])
def test_cli_serve_on_a_mesh_equals_single_process(ranks, served_single,
                                                   run, capsys):
    reports, _, out = ranks
    assert all(r["cli_rc"] == 0 for r in reports)
    want = sorted(served_single.glob("*_depth.npy"))
    got = sorted((out / run).glob("*_depth.npy"))
    assert [p.name for p in got] == [p.name for p in want] and len(want) == 6
    for g, w in zip(got, want):
        # depth in metres (0..100 m): atol 1e-5 of the range
        np.testing.assert_allclose(np.load(g), np.load(w), rtol=1e-5,
                                   atol=1e-3, err_msg=g.name)


# tools/orbax_to_pth.py's flags for the seg_tpu variant's widths
ORBAX_FLAGS = ["--preset", "sup_unsup_seg", "--tpu-decoder"] + [
    a for kv in ("model.img_size=64,128", "model.dims=16,32,32,64",
                 "model.ff_expansion=2,2,2,2", "model.depths=1,1,1,1",
                 "model.mid_channels=32", "model.drop_path_rate=0.0",
                 "model.compute_dtype=float32") for a in ("--set", kv)]


def test_orbax_tpu_decoder_checkpoint_reaches_the_port(inputs, jax_forwards,
                                                       tmp_path, capsys):
    """tools/orbax_to_pth.py on an Orbax checkpoint of a JAX run of the
    seg_tpu variant (sup_unsup_seg + tpu_decoder, which the JAX package's
    export --format pth refuses): the port's forward on the written .pth
    against the JAX forward of the same parameters, fp32 1e-4, argmax
    maps equal; a checkpoint of another variant is refused, rc 2."""
    import importlib.util

    from camradepth_tpu.train.diffgrad import diffgrad_norm
    from camradepth_tpu.train.step import TrainState
    from camradepth_tpu.utils.checkpoint import save_checkpoint

    spec = importlib.util.spec_from_file_location(
        "orbax_to_pth", Path(__file__).resolve().parents[1] / "tools" /
        "orbax_to_pth.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    _, params, xs, _ = inputs
    p = params["seg_tpu"]
    # a trainer's state: the parameters, diffGradNorm's state (its tree
    # and shapes, zeros) and the step
    opt = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        diffgrad_norm(1e-3).init, p))
    save_checkpoint(tmp_path / "run", TrainState(p, opt, np.int32(3)),
                    epoch=0, eval_loss=0.5)
    out = tmp_path / "w.pth"
    assert tool.main(["--checkpoint", str(tmp_path / "run"), "--out",
                      str(out)] + ORBAX_FLAGS) == 0
    model = create_model(ModelConfig(**_model_cfg("seg_tpu")), device="cpu",
                         state_dict=torch.load(out)["state_dict"])
    with torch.no_grad():
        got = {k: v.numpy() for k, v in model_outputs(
            model, torch.from_numpy(xs["seg_tpu"])).items()}
    want = jax_forwards["seg_tpu"].result()
    _assert_no_near_ties(_heads(got), _heads(want),
                         ModelConfig(**_model_cfg("seg_tpu")))
    for key in ("final_seg", "intermediate_seg"):
        np.testing.assert_array_equal(got[key].argmax(-1),
                                      want[key].argmax(-1), err_msg=key)
    _close(got, want, JAX_TOL, "orbax .pth vs JAX")
    # the same checkpoint for the parity variant: refused, nothing written
    assert tool.main(["--checkpoint", str(tmp_path / "run"), "--out",
                      str(tmp_path / "x.pth")] + ORBAX_FLAGS[:2] +
                     ORBAX_FLAGS[3:]) == 2
    assert "does not fit" in capsys.readouterr().err
    assert not (tmp_path / "x.pth").exists()


def test_http_on_a_mesh_answers_infer_batch(ranks):
    report = ranks[0][0]
    assert [a["status"] for a in report["http"]] == [200] * 3
    assert all(a["shape"] == [1, *HW] and a["equal"]
               for a in report["http"]), report["http"]
    # the 3 concurrent requests coalesced into batches of the engine's 2
    assert report["http_batches"] < 3
