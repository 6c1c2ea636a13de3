"""The port's ``cli inspect`` and ``cli bench``
(camradepth_tpu_torch.cli, camradepth_tpu_torch.bench) and
``tools/test_schedule.py``, on the CPU.

- ``cli inspect`` prints the JSON object of ``camradepth_tpu.cli inspect``
  for a reference ``.pth`` (extra keys beside its state dict), a split
  table and an Orbax-style run directory (checkpoint directories, never
  opened); for a run directory of the port's ``.pth`` checkpoints it lists
  the same entries with their file sizes, and for a serving artifact its
  header and blob bytes. A JAX StableHLO artifact, a directory with no
  checkpoint, a missing path and an unknown file give exit code 2 (the
  last with the JAX package's message).
- ``bench.run_bench`` at the tiny widths on the CPU gives finite frames/s,
  the roofline fields and no kernel launch; ``bench.main`` without a card
  prints one JSON line with ``"value": null`` and an error, exit code 1.
- ``tools/test_schedule.py`` replays xdist's loadfile queue on a made-up
  three-file JUnit XML (files by test count, a worker takes the next file
  with 2 or fewer tests left).
"""

import importlib.util
import json
import math
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import camradepth_tpu.utils.checkpoint  # noqa: F401  (its orbax import)
from camradepth_tpu import cli as jcli
from camradepth_tpu_torch import bench, cli
from camradepth_tpu_torch.config import tiny_test_config
from camradepth_tpu_torch.interop import export as X
from tests.torch_port import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _inspect(main, path, capsys):
    capsys.readouterr()
    rc = main(["inspect", str(path)])
    out = capsys.readouterr()
    return rc, (json.loads(out.out) if rc == 0 else out.err)


def _make_pth(tmp):
    path = tmp / "ref.pth"
    torch.save({"state_dict": {"a.weight": torch.ones(3, 4),
                               "a.bias": torch.zeros(4)},
                "lr": 1e-4, "epoch": 3}, path)
    return path


def _make_split(tmp):
    path = tmp / "split.npy"
    rows = np.array([[f"{tmp}/f{i}_{c}.npy" for c in range(7)]
                     for i in range(3)])
    np.save(path, rows)
    return path


def _make_orbax_dir(tmp):
    run = tmp / "run"
    for name, files in (("ckpt_epoch_2_loss_0.5", 2),
                        ("ckpt_epoch_3_loss_0.25", 3),
                        ("ckpt_preempt_epoch_3_step_7", 1)):
        (run / name / "default").mkdir(parents=True)
        for i in range(files):
            (run / name / "default" / f"part{i}").write_bytes(b"x" * (10 + i))
    (run / "events.jsonl").write_text("{}\n")
    return run


@pytest.mark.parametrize("kind", ["pth", "split", "orbax"])
def test_inspect_matches_jax(kind, tmp_path, capsys):
    path = {"pth": _make_pth, "split": _make_split,
            "orbax": _make_orbax_dir}[kind](tmp_path)
    got = _inspect(cli.main, path, capsys)
    want = _inspect(jcli.main, path, capsys)
    assert got == want and got[0] == 0


def test_inspect_port_run_dir_artifact_and_refusals(tmp_path, capsys):
    from camradepth_tpu_torch.utils import checkpoint as ck

    run = tmp_path / "run"
    run.mkdir()
    state = {"state_dict": {"w": torch.ones(2)}, "step": 9}
    ck.save_checkpoint(run, state, 0, 0.75)
    ck.save_checkpoint(run, state, 1, 0.5)
    ck.save_preemption_checkpoint(run, state, 2)
    rc, info = _inspect(cli.main, run, capsys)
    assert rc == 0 and info["type"] == "run-dir"
    names = [e["name"] for e in info["checkpoints"]]
    assert names == ["ckpt_epoch_1_loss_0.7500000.pth",
                     "ckpt_epoch_2_loss_0.5000000.pth",
                     "ckpt_preempt_epoch_2_step_9.pth"], names
    assert [(e.get("eval_loss"), e.get("step")) for e in
            info["checkpoints"]] == [(0.75, None), (0.5, None), (None, 9)]
    assert all(e["bytes"] == (run / e["name"]).stat().st_size
               for e in info["checkpoints"])
    assert info["latest"] == str(run / "ckpt_preempt_epoch_2_step_9.pth")
    # a serving artifact: its header and the bytes of its program
    art = tmp_path / "a.pt2"
    hdr = json.dumps({"format": X.FORMAT, "img_size": [64, 128]}).encode()
    art.write_bytes(X.MAGIC + struct.pack("<Q", len(hdr)) + hdr + b"p" * 5)
    rc, info = _inspect(cli.main, art, capsys)
    assert rc == 0 and info["type"] == "torch-export-artifact"
    assert info["header"]["img_size"] == [64, 128]
    assert info["blob_bytes"] == 5
    # refused: a JAX artifact, no checkpoint, no file, an unknown file
    (tmp_path / "j.stablehlo").write_bytes(X.JAX_MAGIC + b"\0" * 8)
    (tmp_path / "empty").mkdir()
    (tmp_path / "notes.txt").write_text("x")
    for name, text in (("j.stablehlo", "JAX StableHLO artifact"),
                       ("empty", "holds no ckpt_epoch_*"),
                       ("missing.pth", "does not exist"),
                       ("notes.txt", "unrecognized artifact")):
        rc, err = _inspect(cli.main, tmp_path / name, capsys)
        assert rc == 2 and text in err, (name, err)
    rc, err = _inspect(cli.main, tmp_path / "notes.txt", capsys)
    assert err == _inspect(jcli.main, tmp_path / "notes.txt", capsys)[1]


def test_run_bench_on_the_cpu():
    r = bench.run_bench(tiny_test_config(), device="cpu", batch=2, iters=1)
    assert r["fps"] > 0 and r["batch1_latency_ms"] > 0
    assert r["launches_per_forward"] == {
        "maxpool_attention_scores": 0, "upsample_bicubic_x2": 0,
        "gelu_bf16": 0}
    for k in ("gflops_per_frame", "attainable_ms_per_frame"):
        assert math.isfinite(r[k]) and r[k] > 0, k
    # against a CPU time at the tiny size, the achieved TFLOP/s and the
    # roofline share round to 0.0 or near it
    for k in ("achieved_tflops", "roofline_pct"):
        assert math.isfinite(r[k]) and r[k] >= 0, k


def test_bench_without_a_card_prints_one_line(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert cli.main(["bench"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] is None and "CUDA is not available" in line["error"]
    assert line["metric"] == ("nuScenes 416x800 camera+radar inference "
                              "throughput")
    assert bench.baseline_fps() == json.loads(
        (ROOT / "baseline_measured.json").read_text())["baseline_fps"]


def test_schedule_replays_the_xdist_queue(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "test_schedule", ROOT / "tools" / "test_schedule.py")
    sched = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sched)
    cases = {"tests/test_a.py": [1.0, 1.0, 1.0, 1.0],
             "tests/test_b.py": [5.0, 5.0, 5.0],
             "tests/test_c.py": [2.0, 2.0, 2.0]}
    xml = ["<testsuites><testsuite>"]
    for name, times in cases.items():
        mod = name[:-3].replace("/", ".")
        xml += [f'<testcase classname="{mod}" name="t{i}" time="{t}"/>'
                for i, t in enumerate(times)]
    (tmp_path / "run.xml").write_text("".join(xml) + "</testsuite>"
                                      "</testsuites>")
    files = sched.junit_files(str(tmp_path / "run.xml"))
    assert files == cases
    # two workers: a (4 tests) to gw0, b (3, before c in collection
    # order) to gw1; neither takes a second file at the start (4 and 3
    # tests left, more than 2)
    nodes = sched.simulate(files, workers=2)
    ends = {n.name: n.t for n in nodes}
    runs = {n.name: [(r.file, r.start) for r in n.runs] for n in nodes}
    # gw0 runs a; after its 2nd test (t = 2) 2 are left: it takes c, and
    # finishes a at 4 and c at 10; gw1 runs b alone, to 15
    assert runs == {"gw0": [("tests/test_a.py", 0.0),
                            ("tests/test_c.py", 4.0)],
                    "gw1": [("tests/test_b.py", 0.0)]}
    assert ends == {"gw0": 10.0, "gw1": 15.0}
    assert sched.main([str(tmp_path / "run.xml"), "--workers", "2",
                       "--file", "test_c.py"]) == 0
    out = capsys.readouterr().out
    assert "slowest worker: 15.0 s" in out
    assert "test_c.py (3 tests) starts at 4.0 s on gw0" in out
