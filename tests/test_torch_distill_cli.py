"""``cli distill`` end to end on the CPU, and its refusals (beside
tests/test_torch_distill.py, whose JAX step they do not need; a file of 8
or fewer tests queues behind the suite's longest file under ``--dist
loadfile``).

- ``cli distill`` from a port trainer checkpoint (dense, and from its run
  directory with ``--wire on``): the warm start's count, finite logged
  terms, a best checkpoint that ``cli serve --tpu-decoder`` serves;
- the CLI's refusals, each in one line.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest

from camradepth_tpu_torch import cli
from camradepth_tpu_torch.config import DataConfig, TrainConfig
from camradepth_tpu_torch.config import tiny_test_config
from camradepth_tpu_torch.data import synthetic
from camradepth_tpu_torch.models.camradepth import create_model
from camradepth_tpu_torch.train.diffgrad import DiffGradNorm
from camradepth_tpu_torch.utils import checkpoint as ckpt_util
from tests.test_torch_distill import DISTILL_TERMS, TINY_FLAGS
from tests.test_torch_train import HW
from tests.torch_port import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """The metric writer without TensorBoard (its import pulls in
    TensorFlow, ~17 s), as in tests/test_torch_trainer.py."""
    saved = sys.modules.get("tensorboard", False)
    sys.modules["tensorboard"] = None  # import raises ImportError
    yield
    if saved is False:
        del sys.modules["tensorboard"]
    else:
        sys.modules["tensorboard"] = saved


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 9-frame corpus, and a trainer checkpoint of the tiny base teacher
    (model, optimizer and step, as ``cli train`` writes it) in a run
    directory."""
    d = tmp_path_factory.mktemp("distill")
    split = synthetic.generate(d / "data", num_frames=9, hw=HW, seed=2)
    cfg = tiny_test_config()
    model = create_model(dataclasses.replace(cfg.model, img_size=HW),
                         device="cpu", seed=7, train=True)
    run = d / "teacher_run"
    run.mkdir()
    path = ckpt_util.save_checkpoint(run, ckpt_util.host_snapshot(
        model, DiffGradNorm(model.parameters(), lr=1e-3), 3), 0, 0.5)
    return split, run, path


def _trainer_cfgs(split):
    cfg = tiny_test_config()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, img_size=HW, tpu_decoder=True),
        data=DataConfig(image_dimension=HW, split_path=str(split),
                        train_val_split=(4, 2), num_workers=2),
        train=TrainConfig(batch_size=2, desired_batch_size=4,
                          num_steps=None, num_epochs=1))
    return cfg, cfg.replace(model=dataclasses.replace(cfg.model,
                                                      tpu_decoder=False))


@pytest.mark.parametrize("wire", ["off", "on"])
def test_cli_distill_then_serve_on_the_cpu(corpus, tmp_path, capsys, wire):
    """From the trainer checkpoint's file (dense) or its run directory
    (wire): one optimizer step of batch 2 x 2, padded to 3, eval and a best
    checkpoint, which ``cli serve --tpu-decoder`` serves."""
    split, run, path = corpus
    teacher = str(path) if wire == "off" else str(run)
    run_dir = tmp_path / "run"
    rc = cli.main(["distill", "--teacher-checkpoint", teacher,
                   "--tpu-decoder", "--split", str(split),
                   "--train-val-split", "4,2", "--batch-size", "2",
                   "--desired-batch-size", "4", "--num-epochs", "1",
                   "--pad-microbatch", "3", "--run-dir", str(run_dir),
                   "--save-model", "--device", "cpu", "--wire", wire,
                   "--set", "train.log_every=1"] + TINY_FLAGS)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "#### teacher warm start: 155/177 param tensors transferred" in out
    rows = [json.loads(x) for x in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    logged = {r["tag"]: r["value"] for r in rows}
    for k in DISTILL_TERMS:
        assert np.isfinite(logged[f"train/{k}"]), k
    assert np.isfinite(logged["val/loss"])
    best = ckpt_util.best_checkpoint(run_dir)
    assert best is not None
    served = tmp_path / "served"
    rc = cli.main(["serve", "--tpu-decoder", "--split", str(split),
                   "--checkpoint", str(best), "--device", "cpu", "--out",
                   str(served), "--serve-batch", "2", "--wire", wire]
                  + TINY_FLAGS + ["--set", "data.mini_dataset=1"])
    assert rc == 0
    maps = [np.load(p) for p in sorted(served.glob("*_depth.npy"))]
    assert len(maps) == 9
    assert all(m.shape == HW and np.isfinite(m).all() for m in maps)


def test_cli_distill_refuses_in_one_line(corpus, tmp_path, capsys):
    split, _, path = corpus
    orbax = tmp_path / "ckpt_epoch_1"
    orbax.mkdir()
    common = ["--split", str(split), "--train-val-split", "4,2",
              "--device", "cpu"] + TINY_FLAGS
    for extra, match in (
            (["--teacher-checkpoint", str(path), "--data-parallel", "2"],
             "needs 2 ranks, have 1"),
            (["--teacher-checkpoint", str(path), "--spatial-parallel", "2"],
             "needs 2 ranks, have 1"),
            (["--teacher-checkpoint", str(orbax)],
             "camradepth_tpu.cli export --format pth"),
            # a parity checkpoint is no tpu_decoder teacher
            (["--teacher-checkpoint", str(path), "--teacher-tpu-decoder"],
             "--no-strict-teacher"),
            (["--teacher-checkpoint", str(path), "--alpha", "2"], "alpha"),
    ):
        rc = cli.main(["distill", "--tpu-decoder"] + common + extra)
        err = capsys.readouterr().err.strip()
        assert rc == 2 and match in err, err
        assert err.startswith("error:") and "\n" not in err, err
    # with --no-strict-teacher the mismatched tensors keep a fresh init
    rc = cli.main(["distill", "--tpu-decoder", "--teacher-tpu-decoder",
                   "--no-strict-teacher", "--teacher-checkpoint", str(path),
                   "--num-epochs", "1", "--batch-size", "2",
                   "--desired-batch-size", "4", "--run-dir",
                   str(tmp_path / "run")] + common)
    assert rc == 0
