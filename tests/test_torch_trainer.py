"""The port's single-device trainer and ``cli train`` on the CPU, at tiny
widths on a synthetic corpus: train, eval, the best checkpoint and
``load_engine`` on it (also for a seg preset and the tpu_decoder variant); auto-resume after an epoch and a SIGTERM mid-epoch
followed by a resume, each giving the parameters of an uninterrupted run
bit for bit; eval frames counted once; the checkpoint rules of the JAX
package (``tests/test_preemption.py:52-81``).

TensorBoard is kept out of these runs (importing it here pulls in
TensorFlow, ~17 s): the metric writer then writes its JSONL alone, as it
does wherever TensorBoard is not installed.
"""

import dataclasses
import json
import os
import signal
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from camradepth_tpu_torch import cli
from camradepth_tpu_torch.config import (
    DataConfig,
    TrainConfig,
    apply_overrides,
    num_epochs_for_steps,
    tiny_test_config,
)
from camradepth_tpu_torch.config import preset as preset_config
from camradepth_tpu_torch.data import synthetic
from camradepth_tpu_torch.parallel.mesh import training_layout
from camradepth_tpu_torch.serving import load_engine
from camradepth_tpu_torch.train.step import eval_step
from camradepth_tpu_torch.train.trainer import Trainer
from camradepth_tpu_torch.utils import checkpoint as ckpt_util
from tests.torch_port import one_torch_thread  # noqa: F401

HW = (32, 64)
TINY_FLAGS = ["--set", "model.img_size=32,64", "--set",
              "model.dims=16,32,32,64", "--set", "model.ff_expansion=2,2,2,2",
              "--set", "model.depths=1,1,1,1", "--set",
              "model.mid_channels=32", "--set", "data.image_dimension=32,64"]


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    saved = sys.modules.get("tensorboard", False)
    sys.modules["tensorboard"] = None  # import raises ImportError
    yield
    if saved is False:
        del sys.modules["tensorboard"]
    else:
        sys.modules["tensorboard"] = saved


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    return str(synthetic.generate(d, num_frames=11, hw=HW, seed=1))


def _cfg(split, out_dir, **train_kw):
    cfg = tiny_test_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, img_size=HW,
                                                drop_path_rate=0.1))
    data = DataConfig(image_dimension=HW, split_path=split,
                      train_val_split=(8, 3), num_workers=2)
    # batch 2 x update_interval 2: two optimizer steps per epoch
    train = dict(batch_size=2, desired_batch_size=4, num_steps=None,
                 num_epochs=2, learning_rate=1e-3, output_dir=str(out_dir),
                 save_model=True, stop_after=10, log_every=1)
    train.update(train_kw)
    return cfg.replace(data=data, train=TrainConfig(**train))


def _params(trainer):
    return {k: v.detach().clone() for k, v in
            trainer.model.state_dict().items()}


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def uninterrupted(corpus, tmp_path_factory):
    """Two epochs without a break: (trainer, final parameters)."""
    out = tmp_path_factory.mktemp("full")
    tr = Trainer(_cfg(corpus, out), run_dir=str(out / "run"), device="cpu")
    best = tr.train()
    assert np.isfinite(best)
    return tr, _params(tr)


def test_train_eval_checkpoint_and_serve(uninterrupted):
    tr, _ = uninterrupted
    assert tr.training_steps == 4
    rows = [json.loads(x) for x in
            (tr.run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["value"] for r in rows if r["tag"] == "train/loss"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert sum(r["tag"] == "val/loss" for r in rows) == 2
    best = ckpt_util.best_checkpoint(tr.run_dir)
    assert best is not None and best.suffix == ".pth"
    state = ckpt_util.restore_checkpoint(best)
    assert set(state) == {"state_dict", "optimizer", "step"}
    assert all(v.dtype == torch.float32 for v in state["state_dict"].values())
    engine = load_engine(tr.cfg, str(best), batch_size=2, device="cpu")
    frames = np.random.default_rng(0).standard_normal(
        (3, *HW, 7)).astype(np.float32)
    out = engine.infer_batch(frames[:2])
    assert out["depth"].shape == (2, *HW) and np.isfinite(out["depth"]).all()


def test_auto_resume_after_an_epoch_matches_an_uninterrupted_run(
        corpus, tmp_path, uninterrupted):
    _, want = uninterrupted
    cfg = _cfg(corpus, tmp_path)
    first = Trainer(cfg.replace(train=dataclasses.replace(
        cfg.train, stop_after=1)), run_dir=str(tmp_path / "run"),
        device="cpu")
    first.train()  # one epoch, then stop_after
    assert ckpt_util.latest_checkpoint(first.run_dir).name.startswith(
        "ckpt_epoch_1_")
    second = Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu",
                     auto_resume=True)
    assert (second.start_epoch, second.training_steps) == (1, 2)
    second.train()
    assert second.training_steps == 4
    _same(_params(second), want)


def test_sigterm_mid_epoch_then_resume_matches_an_uninterrupted_run(
        corpus, tmp_path, uninterrupted):
    _, want = uninterrupted
    cfg = _cfg(corpus, tmp_path)
    tr = Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu")
    real = tr._train_step
    calls = {"n": 0}

    def step_then_sigterm(*a):
        out = real(*a)
        calls["n"] += 1
        if calls["n"] == 3:  # the first step of the second epoch
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    tr._train_step = step_then_sigterm
    prev = signal.getsignal(signal.SIGTERM)
    tr.train()
    assert signal.getsignal(signal.SIGTERM) == prev
    assert tr._preempted and calls["n"] == 3
    latest = ckpt_util.latest_checkpoint(tr.run_dir)
    assert latest.name == "ckpt_preempt_epoch_1_step_3.pth"
    resumed = Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu",
                      auto_resume=True)
    assert (resumed.start_epoch, resumed.training_steps) == (1, 3)
    _same(_params(resumed), _params(tr))
    resumed.train()
    assert not resumed._preempted and resumed.training_steps == 4
    _same(_params(resumed), want)
    assert ckpt_util.latest_checkpoint(resumed.run_dir).name.startswith(
        "ckpt_epoch_2_")


def test_eval_counts_each_frame_once(uninterrupted):
    """3 val frames at batch 2: the loader repeats the last frame to fill
    the second batch and marks it invalid; the mean counts it once."""
    tr, _ = uninterrupted
    agg = tr.evaluate()
    per_frame = []
    tr.model.eval()
    try:
        for batch in tr.loaders["val"]:
            dev = tr._to_device(batch)
            m = eval_step(tr.cfg, tr.model, dev)["loss"].numpy()
            per_frame += list(m[batch["valid"] > 0])
    finally:
        tr.model.train()
    assert len(per_frame) == 3
    np.testing.assert_allclose(agg["loss"], np.mean(per_frame), rtol=1e-6)


def test_checkpoint_names_follow_the_jax_rules(tmp_path):
    for name in ("ckpt_epoch_2_loss_0.5000000.pth",
                 "ckpt_preempt_epoch_2_step_14.pth"):
        (tmp_path / name).touch()
    # equal epochs completed: the preempt save also holds part of epoch 3
    assert ckpt_util.latest_checkpoint(tmp_path).name == (
        "ckpt_preempt_epoch_2_step_14.pth")
    (tmp_path / "ckpt_epoch_3_loss_0.4000000.pth").touch()
    (tmp_path / "ckpt_preempt_epoch_1_step_380.pth").touch()
    assert ckpt_util.latest_checkpoint(tmp_path).name == (
        "ckpt_epoch_3_loss_0.4000000.pth")
    assert ckpt_util.best_checkpoint(tmp_path).name == (
        "ckpt_epoch_3_loss_0.4000000.pth")
    assert ckpt_util.epochs_completed(
        tmp_path / "ckpt_preempt_epoch_2_step_14.pth") == 2


def test_run_dir_holds_the_jax_run_snapshot(corpus, tmp_path):
    """The run directory gets what the JAX trainer's ``_snapshot_run``
    writes (``camradepth_tpu/train/trainer.py:166-199``): project_files/
    with the resolved config, the git revision and the copied model and
    train sources, named as JAX names them (read from its source)."""
    import ast

    import camradepth_tpu

    src = Path(camradepth_tpu.__file__).parent / "train" / "trainer.py"
    fn = next(n for n in ast.walk(ast.parse(src.read_text()))
              if isinstance(n, ast.FunctionDef) and n.name == "_snapshot_run")
    copied = next(ast.literal_eval(n.iter) for n in ast.walk(fn)
                  if isinstance(n, ast.For) and isinstance(n.iter, ast.Tuple))
    want = {"config.json", "GIT_REVISION"} | {
        rel.replace("/", "__") for rel in copied}
    cfg = _cfg(corpus, tmp_path)
    tr = Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu")
    snap = tr.run_dir / "project_files"
    assert {p.name for p in snap.iterdir()} == want
    assert json.loads((snap / "config.json").read_text()) == json.loads(
        json.dumps(dataclasses.asdict(cfg), default=str))
    pkg = Path(cli.__file__).parent
    for rel in copied:
        assert (snap / rel.replace("/", "__")).read_bytes() == (
            pkg / rel).read_bytes(), rel
    # a commit id, or empty outside a git checkout (as JAX writes it)
    assert len((snap / "GIT_REVISION").read_text().strip()) in (0, 40)


def test_async_saver_writes_the_snapshot_it_was_given(tmp_path):
    model = torch.nn.Linear(3, 2)
    state = ckpt_util.host_snapshot(model, None, 7)
    saver = ckpt_util.AsyncSaver()
    path = saver.save(tmp_path, state, 0, 0.25)
    with torch.no_grad():
        model.weight.add_(1.0)  # the live tensor moves on; the copy not
    saver.close()
    back = ckpt_util.restore_checkpoint(path)
    assert path.name == "ckpt_epoch_1_loss_0.2500000.pth"
    assert back["step"] == 7
    assert torch.equal(back["state_dict"]["weight"],
                       state["state_dict"]["weight"])
    assert not torch.equal(back["state_dict"]["weight"], model.weight)


def test_cli_train_on_the_cpu(corpus, tmp_path, capsys):
    run_dir = tmp_path / "run"
    rc = cli.main(["train", "--split", corpus, "--train-val-split", "8,3",
                   "--device", "cpu", "--run-dir", str(run_dir),
                   "--save-model", "--async-checkpoint", "--batch-size", "2",
                   "--desired-batch-size", "4", "--num-epochs", "1",
                   "--set", "data.num_workers=2"] + TINY_FLAGS)
    assert rc == 0
    # no multi-device flag: one device, no process group
    assert not torch.distributed.is_initialized()
    out = capsys.readouterr().out
    assert "best val loss:" in out
    best = ckpt_util.best_checkpoint(run_dir)
    assert best is not None
    # the checkpoint is a reference-format .pth: cli test takes it
    rc = cli.main(["test", "--split", corpus, "--set", "data.mini_dataset=1",
                   "--checkpoint", str(best), "--device", "cpu",
                   "--test-batch", "4"] + TINY_FLAGS)
    assert rc == 0


def test_cli_train_then_serve_the_seg_tpu_decoder_variant(corpus, tmp_path,
                                                          capsys):
    """sup_unsup_seg with the tpu_decoder variant trains through ``cli
    train`` (the seg losses on); its best checkpoint loads into
    ``load_engine``, which serves depth and uint8 labels, and into ``cli
    test``, whose report has the IoU row."""
    preset, extra = "sup_unsup_seg", ["--tpu-decoder"]
    run_dir = tmp_path / "run"
    rc = cli.main(["train", "--preset", preset, "--split", corpus,
                   "--train-val-split", "8,3", "--device", "cpu",
                   "--run-dir", str(run_dir), "--save-model",
                   "--batch-size", "2", "--desired-batch-size", "4",
                   "--num-epochs", "1", "--set", "data.num_workers=2",
                   "--set", "train.log_every=1"] + TINY_FLAGS + extra)
    assert rc == 0
    rows = [json.loads(x) for x in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    seg = [r["value"] for r in rows if r["tag"] == "train/loss_seg_final"]
    assert len(seg) == 2 and all(np.isfinite(seg)) and min(seg) > 0
    best = ckpt_util.best_checkpoint(run_dir)
    cfg = apply_overrides(preset_config(preset), TINY_FLAGS[1::2])
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, tpu_decoder=True))
    engine = load_engine(cfg, str(best), batch_size=2, device="cpu")
    out = engine.infer_batch(np.random.default_rng(0).standard_normal(
        (2, *HW, 7)).astype(np.float32))
    assert out["depth"].shape == (2, *HW) and np.isfinite(out["depth"]).all()
    assert out["seg"].dtype == np.uint8 and out["seg"].shape == (2, *HW)
    assert out["seg"].max() < cfg.model.num_classes
    report = tmp_path / "report.json"
    capsys.readouterr()
    rc = cli.main(["test", "--preset", preset, "--split", corpus, "--set",
                   "data.mini_dataset=1", "--checkpoint", str(best),
                   "--device", "cpu", "--test-batch", "4", "--report-json",
                   str(report)] + TINY_FLAGS + extra)
    assert rc == 0
    assert np.isfinite(json.loads(report.read_text())["iou"])
    assert "IoU:" in capsys.readouterr().out


# why each multi-device flag is refused in a one-process run: a layout
# needs as many ranks as it covers, spatial parallel too (it trains at
# sp = 2 on two ranks); --multihost reads torchrun's environment;
# --coordinator needs the rest
_MULTI_DEVICE_REFUSALS = {
    "--data-parallel": "needs 2 ranks, have 1",
    "--fsdp": "needs 2 ranks, have 1",
    "--spatial-parallel": "needs 2 ranks, have 1",
    "--multihost": "torchrun",
    "--coordinator": "requires --num-processes and --process-id",
}


@pytest.mark.parametrize("flag", [["--data-parallel", "2"], ["--fsdp", "2"],
                                  ["--spatial-parallel", "2"],
                                  ["--multihost"],
                                  ["--coordinator", "localhost:1234"]])
def test_cli_train_refuses_multi_device_flags(flag, capsys, monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert cli.main(["train", "--device", "cpu"] + flag) == 2
    err = capsys.readouterr().err
    assert _MULTI_DEVICE_REFUSALS[flag[0]] in err, err
    assert err.startswith("error:") and err.count("\n") == 1, err


def test_train_overrides_and_epoch_count():
    cfg = apply_overrides(tiny_test_config(), [
        "train.desired_batch_size=6", "train.batch_size=3",
        "train.num_steps=100", "data.train_val_split=30,5",
        "train.checkpoint=w.pth"])
    assert cfg.train.update_interval == 2
    assert cfg.train.checkpoint == "w.pth"
    assert num_epochs_for_steps(cfg) == 10  # 100 steps * 3 / 30 frames
    assert apply_overrides(cfg, ["mesh.data_parallel=2",
                                 "mesh.fsdp_parallel=2"]).mesh.fsdp_parallel \
        == 2
    # sp = 2 trains on two ranks (tests/test_torch_spatial_train.py), and
    # is refused on one
    sp = apply_overrides(cfg, ["mesh.spatial_parallel=2"])
    assert sp.mesh.spatial_parallel == 2
    assert training_layout(sp, 2).kind == "sp"
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        training_layout(sp, 1)
    with pytest.raises(ValueError, match="multiple of batch_size"):
        apply_overrides(cfg, ["train.desired_batch_size=7"])
