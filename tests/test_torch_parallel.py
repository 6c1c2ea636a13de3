"""Multi-device training of the port (camradepth_tpu_torch.parallel) on the
CPU, against its single-process step and the JAX package's rules.

The module starts one gloo group of two processes
(``tests/_torch_parallel_child.py``, forked by ``tests/torch_ranks.py``
from one process that imports their code once; one torch thread each,
tiny widths, fp32) when it starts, runs its tests that need no process
meanwhile, and then reads what each rank reports. The single-process reference is the
port's own step over the joined microbatch: tests/test_torch_train.py
holds that step to the JAX one, so no JAX step is compiled here. The
model is supervised_seg with both focal CE terms on and dropout at the
ModelConfig rates (drop path 0.1, Dropout2d 0.2); of each microbatch the
second rank's rows hold at most 10 % valid GT and 95 % ignored labels, so
the ranks' normalizers differ. Each layout's two optimizer steps (DDP and
FSDP2) are held to:

- the loss, rtol 1e-6 in each step (the focal CE terms too);
- each parameter's gradient in the last step, relative L2 1e-5;
- the parameters after the two steps, relative L2 1e-5 over all of them
  together (measured here: 4.8e-8 to 6.0e-8). Per parameter a
  zero-initialised bias reached 2.4e-5: diffGrad's update of an element
  whose gradient is small against eps is linear in it, so the
  summation-order roundoff of that gradient element moves it, by at most
  7.8e-4 * lr here.

``grad_parity`` holds on both layouts, both ranks report the same metrics
bit for bit, and the per-rank-normalizer step (each rank's own masked
means, averaged) misses the gradient limit, which keeps the limits
honest. ``cli train --coordinator`` under FSDP2 runs one step: rank 0
alone writes the run directory, and its best checkpoint loads with
``load_engine`` to the parameters the step produced.

Without processes: the layout sizing against the JAX trainer's
``_auto_mesh`` on the 8 virtual CPU devices, each rank's train rows
against JAX ``make_loaders(process_shard=...)``, and the refusals.
"""

import dataclasses
import json
import socket

import numpy as np
import pytest
import torch

from camradepth_tpu_torch import cli
from camradepth_tpu_torch.config import (
    ConfigError,
    MeshConfig,
    apply_overrides,
    preset,
)
from camradepth_tpu_torch.data import synthetic
from camradepth_tpu_torch.data.pipeline import make_loaders
from camradepth_tpu_torch.parallel import multihost
from camradepth_tpu_torch.parallel.gradcheck import (
    check_config,
    parity_microbatches,
)
from camradepth_tpu_torch.parallel.mesh import (
    Layout,
    mesh_shape,
    training_layout,
)
from camradepth_tpu_torch.serving import load_engine
from camradepth_tpu_torch.train.trainer import Trainer
from tests import torch_ranks
from tests.torch_port import one_torch_thread  # noqa: F401

CHILD = "tests._torch_parallel_child"
WORLD = 2
LAYOUTS = ("ddp", "fsdp")
# the widths of the children's cli train (tests/_torch_parallel_child.py)
TINY = ["model.img_size=32,64", "model.dims=16,32,32,64",
        "model.ff_expansion=2,2,2,2", "model.depths=1,1,1,1",
        "model.mid_channels=32", "data.image_dimension=32,64"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    return synthetic.generate(d, num_frames=4, hw=(32, 64), seed=1)


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
    """Both ranks' reports and the run directory of their ``cli train``."""
    proc, out = spawned
    torch_ranks.wait(proc, WORLD)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(WORLD)], out


def _check_step(r):
    print({k: v for k, v in r.items() if k != "metrics"})
    assert r["loss_rel"] <= 1e-6, r["loss_rel"]
    assert r["grad_rel"] <= 1e-5, (r["grad_worst"], r["grad_rel"])
    assert r["params_rel"] <= 1e-5, r["params_rel"]


# ------------------------------------------------- no processes (first)
def test_layout_sizing_matches_jax_auto_mesh():
    """mesh_shape over a grid of batch sizes and flags on 8 ranks is the
    mesh shape of camradepth_tpu.train.trainer._auto_mesh on the 8
    virtual CPU devices, or both refuse."""
    import jax

    from camradepth_tpu.config import ConfigError as JaxConfigError
    from camradepth_tpu.config import MeshConfig as JaxMeshConfig
    from camradepth_tpu.config import tiny_test_config as jax_tiny
    from camradepth_tpu.train.trainer import _auto_mesh

    assert len(jax.devices()) == 8
    base = jax_tiny()
    seen = {"mesh": 0, "none": 0, "refused": 0}
    for batch in (1, 2, 3, 4, 6, 8, 12):
        for data in (-1, 1, 2, 3, 4, 8):
            for fsdp in (1, 2, 4):
                for sp in (1, 2, 3):
                    cfg = base.replace(
                        mesh=JaxMeshConfig(data_parallel=data,
                                           fsdp_parallel=fsdp,
                                           spatial_parallel=sp),
                        train=dataclasses.replace(
                            base.train, batch_size=batch,
                            desired_batch_size=batch))
                    try:
                        mesh = _auto_mesh(cfg)
                        want = None if mesh is None else tuple(
                            mesh.shape[a] for a in ("data", "fsdp", "sp"))
                    except JaxConfigError:
                        want = "refused"
                    try:
                        got = mesh_shape(data, fsdp, sp, 8, batch,
                                         cfg.model.img_size[0])
                    except ConfigError:
                        got = "refused"
                    assert got == want, (batch, data, fsdp, sp, got, want)
                    seen["refused" if want == "refused" else
                         "none" if want is None else "mesh"] += 1
    assert min(seen.values()) > 0, seen  # the grid meets every outcome


def test_training_layout_covers_every_rank():
    cfg = preset("base")

    def layout(world, **mesh):
        return training_layout(cfg.replace(mesh=MeshConfig(**mesh)), world)

    assert layout(1) is None  # nothing wrapped on one device
    assert layout(2) == Layout(2, 1) and layout(2).kind == "ddp"
    assert layout(2, fsdp_parallel=2).kind == "fsdp"
    big = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=4,
                                                desired_batch_size=4))
    assert training_layout(big.replace(mesh=MeshConfig(
        data_parallel=2, fsdp_parallel=2)), 4) == Layout(2, 2)
    with pytest.raises(ConfigError, match="covers 2 of 4 ranks"):
        layout(4)  # batch 2: two ranks would hold no row
    with pytest.raises(ConfigError, match="needs 2 ranks, have 1"):
        layout(1, data_parallel=2)
    # sp = 2 alone trains (tests/test_torch_spatial_train.py)
    sp = training_layout(cfg.replace(mesh=MeshConfig(spatial_parallel=2)), 2)
    assert sp == Layout(sp=2) and sp.kind == "sp" and sp.size == 2


def test_process_shard_rows_match_jax_make_loaders(tmp_path):
    from camradepth_tpu.config import DataConfig as JaxDataConfig
    from camradepth_tpu.data.pipeline import make_loaders as jax_loaders

    rows = np.array([[f"f{i}_{c}" for c in range(7)] for i in range(13)])
    split = tmp_path / "split.npy"
    np.save(split, rows)
    kw = dict(split_path=str(split), train_val_split=(9, 3))
    port_cfg = dataclasses.replace(preset("base").data, **kw)
    jax_cfg = JaxDataConfig(**kw)
    for world in (2, 3, 4):
        for rank in range(world):
            got = make_loaders(port_cfg, 1, process_shard=(rank, world))
            want = jax_loaders(jax_cfg, 1, process_shard=(rank, world))
            for part in ("train", "val", "test"):
                np.testing.assert_array_equal(got[part].frames.rows,
                                              want[part].frames.rows)
            assert len(got["train"].frames) == 9 // world


def test_multi_process_trainer_refusals(corpus, monkeypatch, tmp_path):
    """With more than one rank: no run dir, or wire on, is refused before
    anything is built (a two-rank group, as the trainer sees it)."""
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    cfg = preset("base")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               split_path=str(corpus)))
    with pytest.raises(ConfigError, match="explicit run_dir"):
        Trainer(cfg, device="cpu")
    wire = cfg.replace(data=dataclasses.replace(cfg.data, wire_format="on"))
    with pytest.raises(ConfigError, match="wire_format=on requires"):
        Trainer(wire, run_dir=str(tmp_path), device="cpu")


# test scores on one process, as JAX's cli test; serve on one process has
# no second rank for its sp group (train and distill take sp = 2:
# tests/test_torch_spatial_train.py)
SP_REFUSALS = {"test": "test scores on one process",
               "serve": "needs 2 ranks, have 1"}


@pytest.mark.parametrize("command", ["test", "serve"])
def test_spatial_parallel_is_refused_naming_item_10b(command, corpus, capsys):
    extra = {"distill": ["--teacher-checkpoint", "t.pth"],
             "test": ["--checkpoint", "w.pth"],
             "serve": ["--checkpoint", "w.pth"]}.get(command, [])
    assert cli.main([command, "--split", str(corpus), "--device", "cpu",
                     "--spatial-parallel", "2"] + extra) == 2
    assert SP_REFUSALS[command] in capsys.readouterr().err


# --------------------------------------------------- the two ranks
@pytest.mark.parametrize("kind", LAYOUTS)
def test_step_equals_the_single_process_step(ranks, kind):
    """Two optimizer steps, dropout on, uneven valid-GT counts."""
    for report in ranks[0]:
        _check_step(report[kind])


@pytest.mark.parametrize("kind", LAYOUTS)
def test_focal_ce_with_mostly_ignored_labels_on_one_rank(ranks, kind):
    """The focal CE takes its transform after the global mean: both terms
    equal the single-process step's though the second rank's labels are
    95 % ignored."""
    cfg = check_config(dropout=True, supervised_seg=True)
    labels = parity_microbatches(cfg, 2, 2 * WORLD, seed=7, ranks=WORLD)
    for micro in labels:
        assert np.mean(micro["seg"][WORLD:] == 255) > 0.9
        assert np.mean(micro["seg"][:WORLD] == 255) < 0.2
    for report in ranks[0]:
        for got, want in zip(report[kind]["metrics"], report["reference"]):
            for key in ("loss_seg_final", "loss_seg_inter"):
                assert want[key] > 0, key
                assert abs(got[key] - want[key]) <= 1e-6 * want[key], (
                    key, got[key], want[key])


@pytest.mark.parametrize("kind", LAYOUTS)
def test_grad_parity_holds(ranks, kind):
    for report in ranks[0]:
        r = report[f"grad_parity_{kind}"]
        assert r["ok"] and not r["bad_leaves"], r
        assert r["max_rel_diff"] <= 1e-5 and r["loss_diff"] <= 1e-6, r


def test_ranks_report_the_same_metrics_bit_for_bit(ranks):
    first, second = ranks[0]
    for key in LAYOUTS:
        assert first[key]["metrics"] == second[key]["metrics"], key
        assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                   for m in first[key]["metrics"]), key


def test_per_rank_normalizers_miss_the_gradient_limit(ranks):
    """Each rank's own masked means, averaged over the ranks, is the step
    a direct port takes: on the uneven batch it is far off the limit."""
    for report in ranks[0]:
        assert report["per_rank"]["grad_rel"] > 100 * 1e-5, report[
            "per_rank"]


def test_cli_train_over_two_processes(ranks):
    """One FSDP2 step through ``cli train --coordinator``: rank 0 alone
    writes (rank 1 holds a NullWriter; one checkpoint; one metrics line
    per tag), and the checkpoint loads on one device to the gathered
    parameters of the step."""
    reports, out = ranks
    assert [r["cli_rc"] for r in reports] == [0, 0]
    assert [r["cli_steps"] for r in reports] == [1, 1]
    assert [r["cli_writer"] for r in reports] == ["MetricWriter",
                                                  "NullWriter"]
    run = out / "run"
    ckpts = sorted(run.glob("ckpt_*"))
    assert len(ckpts) == 1, ckpts
    tags = [json.loads(x)["tag"] for x in
            (run / "metrics.jsonl").read_text().splitlines()]
    assert tags.count("train/loss") == 1 and tags.count("val/loss") == 1
    assert (run / "project_files" / "config.json").is_file()
    cfg = apply_overrides(preset("base"), TINY + [
        "model.compute_dtype=float32"])
    engine = load_engine(cfg, str(ckpts[0]), batch_size=1, device="cpu")
    want = torch.load(out / "step_params.pt")
    got = engine.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
