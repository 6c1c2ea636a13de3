"""The trainer: epochs, validation, early stopping, checkpoints, resume
and preemption, on one device or across ranks.

Counterpart of ``camradepth_tpu/train/trainer.py:166-781``:

- one optimizer step consumes ``update_interval`` microbatches
  (``train/step.py``); the OneCycle schedule is indexed by the optimizer
  step;
- the dropout of microbatch j of step i in epoch e draws from a
  ``torch.Generator`` on the device seeded from (seed, e, i, j), the
  port's counterpart of ``fold_in``, so a run is reproducible and a
  resumed run draws what an uninterrupted one draws;
- microbatches are assembled and copied to the device ahead of the step
  on a worker thread (``utils/prefetch.py``), features in
  ``train.transfer_dtype``; with ``data.wire_format`` auto or on (one
  process: both take the wire where the codec covers the config) every
  loader ships compact wire batches (``data/wire.py``), decoded on the
  device inside the step, and a bf16 transfer rounds their ``radar_val``,
  the one feature payload the wire ships in floats;
- validation runs in eval mode under ``torch.no_grad()``, per frame, with
  the loader's padded tail frames (``batch["valid"]``) and non-finite
  frames dropped from the means;
- early stopping, the ``stop_after = num_epochs - 4`` quirk
  (runner.py:382-384), best-validation checkpoints, auto-resume from the
  newest checkpoint of the run directory (the interrupted epoch's consumed
  steps skipped), and SIGTERM handled at an optimizer-step boundary;
- the run directory gets the resolved config, the git revision and a copy
  of the model and train sources (``project_files/``, as the JAX
  package's ``_snapshot_run``).

On ``cuda`` everything runs on the card: nothing moves to the CPU but the
scalars that are logged.

Multi-device (``parallel/``): the layout comes from ``cfg.mesh`` and the
process group's size (``parallel/mesh.training_layout``), or is given
(``layout=``, e.g. a one-rank DDP or FSDP2 run). The model is built, warm
started and restored on every rank alike, then wrapped; the optimizer
takes the wrapped parameters. Each rank's train loader reads its strided
rows of the split (``make_loaders(process_shard=...)``), its share of each
global batch; val stays whole, and every rank evaluates all of it in
lockstep (an FSDP2 forward needs every rank). The primary alone writes the
run directory (metrics, config, snapshot, checkpoints gathered from every
rank), the best-checkpoint and early-stopping decisions are the primary's,
broadcast, and a SIGTERM on any rank stops every rank at the same step. A
multi-process run needs an explicit run directory and takes dense batches
(wire ``auto`` stays dense; ``on`` is refused). Under the sp layout every
rank loads the same full batches (no ``process_shard``, as the JAX
trainer's sp-only mesh does) and cuts its rows of every map on the device
(``train/step.py``); its eval scores its rows with the sp group's sums, so
every rank reports the same val loss, bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import signal
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from camradepth_tpu_torch import resolve_device
from camradepth_tpu_torch.config import (
    ConfigError,
    ExperimentConfig,
    num_epochs_for_steps,
)
from camradepth_tpu_torch.data.pipeline import make_loaders
from camradepth_tpu_torch.data.wire import WIRE_KEYS, resolve_wire_ship
from camradepth_tpu_torch.models.camradepth import create_model
from camradepth_tpu_torch.parallel import multihost
from camradepth_tpu_torch.parallel.mesh import (
    Layout,
    training_layout,
    unwrap,
    wrap,
)
from camradepth_tpu_torch.train.diffgrad import DiffGradNorm
from camradepth_tpu_torch.train.schedule import onecycle
from camradepth_tpu_torch.train.step import eval_step, train_step
from camradepth_tpu_torch.utils import checkpoint as ckpt_util
from camradepth_tpu_torch.utils.logging import (
    MetricWriter,
    NullWriter,
    create_run_dir,
)
from camradepth_tpu_torch.utils.prefetch import prefetch_iter

# the batch keys a step reads (the seg labels only with a seg branch), of
# dense and of wire batches
_BATCH_KEYS = ("features", "gt_depth") + WIRE_KEYS
_SEG_KEYS = ("seg", "seg_inter")


class _PreemptionMonitor:
    """SIGTERM -> a flag the trainer polls at optimizer-step boundaries;
    ``restore`` puts the previous handlers back. Main thread only."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = False
        self._prev = {s: signal.signal(s, self._handle) for s in signals}

    def _handle(self, signum, frame):
        self._flag = True

    def triggered(self) -> bool:
        return self._flag

    def restore(self) -> None:
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev = {}


def step_generator(device: torch.device, seed: int, epoch: int, step: int,
                   micro: int) -> torch.Generator:
    """The dropout generator of one microbatch, on ``device``, seeded from
    (seed, epoch, step, micro)."""
    s = np.random.SeedSequence([seed, epoch, step, micro]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(
        int(s) & 0x7FFF_FFFF_FFFF_FFFF)


# the sources the run snapshot copies (camradepth_tpu/train/trainer.py:
# 190-199), relative to the package
_SNAPSHOT_SOURCES = ("models/camradepth.py", "models/encoder.py",
                     "models/layers.py", "train/step.py", "train/losses.py",
                     "train/diffgrad.py", "config.py", "data/channels.py")


def snapshot_run(cfg: ExperimentConfig, run_dir: Path) -> None:
    """The run's reproducibility snapshot in ``run_dir/project_files``
    (``camradepth_tpu/train/trainer.py:166-199``; the reference's
    save_files): the resolved config as JSON, the git revision of the
    checkout and a copy of the model and train sources."""
    snap = run_dir / "project_files"
    snap.mkdir(parents=True, exist_ok=True)
    (snap / "config.json").write_text(
        json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
    pkg = Path(__file__).resolve().parents[1]
    try:
        # empty outside a git checkout, as the JAX package writes it
        rev = subprocess.run(["git", "rev-parse", "HEAD"], cwd=pkg.parent,
                             capture_output=True, text=True, timeout=10)
        (snap / "GIT_REVISION").write_text(rev.stdout.strip() + "\n")
    except (OSError, subprocess.SubprocessError):
        pass  # no git: the snapshot goes without the revision
    for rel in _SNAPSHOT_SOURCES:
        shutil.copyfile(pkg / rel, snap / rel.replace("/", "__"))


def run_layout(cfg: ExperimentConfig, run_dir: Optional[str] = None,
               layout: Optional[Layout] = None) -> Optional[Layout]:
    """The layout a run of ``cfg`` trains on (``layout``, else
    ``training_layout``), after the refusals of a multi-process run that
    come before anything is built, as the JAX trainer makes them: no run
    directory, and the compact wire format ``on``."""
    layout = layout if layout is not None else training_layout(cfg)
    if multihost.is_multiprocess():
        if run_dir is None:
            # an auto-indexed directory would differ between the ranks
            raise ConfigError(
                "multi-process training requires an explicit run_dir (pass "
                "--run-dir) so every rank uses the same directory")
        # the compact wire format (camradepth_tpu/train/trainer.py:248-
        # 287): one process takes it for "auto" and "on"; several stay
        # dense, and refuse "on"
        if cfg.data.wire_format == "on":
            raise ConfigError(
                "data.wire_format=on requires a single-process run without "
                "sp sharding (the on-device scatter decode is frame-local); "
                "use wire_format=auto or off")
    return layout


class Trainer:
    def __init__(self, cfg: ExperimentConfig, loaders: Optional[Dict] = None,
                 run_dir: Optional[str] = None, auto_resume: bool = False,
                 device="cuda", layout: Optional[Layout] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.layout = run_layout(cfg, run_dir, layout)
        multi = multihost.is_multiprocess()
        wire = cfg.data.wire_format != "off" and not multi
        sp = self.layout is not None and self.layout.kind == "sp"
        if loaders is None and multi and not sp:
            world = multihost.process_count()
            if cfg.train.batch_size % world:
                raise ConfigError(f"batch_size {cfg.train.batch_size} must "
                                  f"divide over {world} processes")
            loaders = make_loaders(
                cfg.data, cfg.train.batch_size // world,
                process_shard=(multihost.process_index(), world))
        self.loaders = loaders or make_loaders(
            resolve_wire_ship(cfg) if wire else cfg.data,
            cfg.train.batch_size, wire=wire, wire_eval=wire)
        if self.loaders.get("train") is None:
            raise ValueError(
                "training requires a non-empty train split; the current "
                "config assigns 0 frames to train (mini_dataset routes every "
                "frame to test: use 'cli test', or a split with train "
                "frames)")
        steps_per_epoch = max(1, len(self.loaders["train"]))
        self.num_epochs = num_epochs_for_steps(cfg)
        opt_steps = max(1, self.num_epochs * steps_per_epoch
                        // cfg.train.update_interval)
        self.schedule = onecycle(
            cfg.train.learning_rate, total_steps=opt_steps,
            pct_start=cfg.train.pct_start, div_factor=cfg.train.div_factor,
            final_div_factor=cfg.train.final_div_factor)
        self.run_dir = Path(run_dir) if run_dir else create_run_dir(
            cfg.train.output_dir, cfg.train.arch_name, cfg.train.run_name)
        # the primary alone writes the run directory
        self._primary = multihost.is_primary()
        latest = (ckpt_util.latest_checkpoint(self.run_dir) if auto_resume
                  else None)
        self.model = create_model(cfg.model, device=self.device,
                                  seed=cfg.train.seed, train=True)
        # the full state to restore once the model is wrapped: a trainer
        # checkpoint given as train.checkpoint, or the run's newest
        full = None
        if cfg.train.checkpoint and cfg.train.load_ckpt:
            full = self._read_checkpoint(cfg.train.checkpoint)
        if latest is not None:
            full = ckpt_util.restore_checkpoint(latest)
        self._prepare_model(restored=full is not None or bool(
            cfg.train.checkpoint and cfg.train.load_ckpt))
        if self.layout is not None:
            self.model = wrap(self.model, self.layout)
        self.optimizer = DiffGradNorm(
            self.model.parameters(), lr=self.schedule(0),
            betas=cfg.train.betas, eps=cfg.train.eps,
            weight_decay=cfg.train.weight_decay)
        self.training_steps = 0
        self.val_steps = 0
        self.start_epoch = 0
        if full is not None:
            self._restore(full)
        if self._primary:
            self.run_dir.mkdir(parents=True, exist_ok=True)
            self.writer = MetricWriter(self.run_dir)
            (self.run_dir / "config.json").write_text(
                json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
            snapshot_run(cfg, self.run_dir)
        else:
            self.writer = NullWriter()
        self._async_saver = (ckpt_util.AsyncSaver()
                             if cfg.train.async_checkpoint else None)
        self._preempt_monitor: Optional[_PreemptionMonitor] = None
        self._preempted = False
        if latest is not None:
            # both name forms count epochs completed: a regular save
            # resumes at the next epoch, a preempt save restarts the
            # interrupted one and skips its consumed steps
            self.start_epoch = ckpt_util.epochs_completed(latest)
            self._say(f"#### auto-resumed from {latest.name} (epoch "
                      f"{self.start_epoch}, step {self.training_steps})")

    def _say(self, line: str) -> None:
        if self._primary:
            print(line)

    def _prepare_model(self, restored: bool) -> None:
        """Set up the unwrapped model before the layout wraps it (a
        subclass's warm start); ``restored`` when a checkpoint will give
        its weights."""

    # ------------------------------------------------------------------
    def _whole(self) -> bool:
        """Whether the model is the single-device one on every rank: one
        device, or the sp layout (parameters and optimizer state
        replicated, nothing wrapped)."""
        return self.layout is None or self.layout.kind == "sp"

    def state(self) -> Dict:
        """The training state as a host snapshot (model, optimizer,
        step), in the single-device layout under any layout: every rank
        calls it, the primary's holds the state."""
        if self._whole():
            return ckpt_util.host_snapshot(self.model, self.optimizer,
                                           self.training_steps)
        return {**multihost.full_state(self.model, self.optimizer),
                "step": int(self.training_steps)}

    def _restore(self, state: Dict) -> None:
        if self._whole():
            self.model.load_state_dict(state["state_dict"], strict=True)
            if "optimizer" in state:
                self.optimizer.load_state_dict(state["optimizer"])
        else:
            multihost.load_full_state(self.model, self.optimizer, state)
        self.training_steps = int(state.get("step", 0))

    def _read_checkpoint(self, path: str) -> Optional[Dict]:
        """``train.checkpoint``: a full trainer checkpoint is returned, to
        restore the model, the optimizer and the step; any other ``.pth``
        (a reference state_dict) loads its shape-matching parameters into
        the unwrapped model now (runner.py:124-132)."""
        state = ckpt_util.restore_checkpoint(path)
        if isinstance(state, dict) and "optimizer" in state:
            self._say(f"#### restored the full training state from {path}")
            return state
        sd = state.get("state_dict", state) if isinstance(state, dict) \
            else state
        ckpt_util.partial_restore(sd, self.model, verbose=self._primary)
        self._say(f"#### partial-restored params from {path}")
        return None

    # ------------------------------------------------------------------
    def _transfer_dtype(self) -> Optional[torch.dtype]:
        td = self.cfg.train.transfer_dtype
        if td == "auto":
            td = ("bfloat16" if self.cfg.model.compute_dtype == "bfloat16"
                  else "float32")
        if td == "bfloat16":
            return torch.bfloat16
        if td == "float32":
            return None
        raise ValueError(f"train.transfer_dtype must be auto|float32|"
                         f"bfloat16, got {td!r}")

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        """One host batch's arrays on the device, the features in the
        transfer dtype: bf16 is exact when the model computes in bf16, as
        its first operation casts the input. A wire batch ships its image
        as bytes, so only its ``radar_val`` takes the transfer dtype
        (``camradepth_tpu/train/trainer.py:478-499``): the same bits the
        dense bf16 stack carries for those channels."""
        tdt = self._transfer_dtype()
        cast = "features" if "features" in batch else "radar_val"
        out = {}
        keys = _BATCH_KEYS + (_SEG_KEYS if self.cfg.model.supervised_seg
                              else ())
        for k in keys:
            if k in batch and batch[k] is not None:
                t = torch.from_numpy(np.ascontiguousarray(batch[k]))
                if k == cast and tdt is not None:
                    t = t.to(tdt)
                out[k] = t.to(self.device, non_blocking=True)
        return out

    def _micro_source(self, it, n_steps: int):
        accum = self.cfg.train.update_interval
        for _ in range(n_steps):
            try:
                yield [next(it) for _ in range(accum)]
            except StopIteration:
                return

    def _preemption_requested(self) -> bool:
        """The SIGTERM flag; across ranks all-reduced, so that every rank
        stops at the same step (a rank that left alone would strand the
        others in a collective)."""
        if not self.cfg.train.graceful_preemption:
            return False
        return multihost.any_flag(self._preempt_monitor is not None
                                  and self._preempt_monitor.triggered())

    def train_one_epoch(self, epoch: int, skip_opt_steps: int = 0) -> None:
        cfg = self.cfg
        loader = self.loaders["train"]
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        it = iter(loader)
        accum = cfg.train.update_interval
        n_opt_steps = max(1, len(loader) // accum)
        start = min(skip_opt_steps, n_opt_steps)
        for _ in range(start * accum):
            if next(it, None) is None:
                break
        self.model.train()
        t0 = time.perf_counter()
        batches = prefetch_iter(
            self._micro_source(it, n_opt_steps - start),
            max(1, cfg.train.prefetch_batches),
            lambda ms: [self._to_device(b) for b in ms])
        for i in range(start, n_opt_steps):
            micro = next(batches, None)
            if micro is None:
                break
            gens = [step_generator(self.device, cfg.train.seed, epoch, i, j)
                    for j in range(len(micro))]
            metrics = self._train_step(micro, gens,
                                       self.schedule(self.training_steps))
            self.training_steps += 1
            if i % cfg.train.log_every == 0 or i == n_opt_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                if not np.isfinite(m["grad_norm"]):
                    print("#### WARNING: non-finite gradients at step "
                          f"{self.training_steps} - check input scaling")
                m["lr"] = self.schedule(self.training_steps)
                m["steps_per_sec"] = (i + 1 - start) / (
                    time.perf_counter() - t0)
                self.writer.scalars(m, self.training_steps, prefix="train/")
                self._say(f"[epoch {epoch + 1}/{self.num_epochs} step {i + 1}/"
                      f"{n_opt_steps}] loss {m['loss']:.5f} rmse "
                      f"{m['rmse_m']:.3f}m lr {m['lr']:.2e}")
            if self._preemption_requested():
                self._preempted = True
                break
        batches.close()  # stops the prefetch thread at once on a break

    def _train_step(self, micro, gens, lr):
        return train_step(self.cfg, self.model, self.optimizer, micro, gens,
                          lr)

    def evaluate(self) -> Dict[str, float]:
        if self.loaders.get("val") is None:
            raise ValueError("validation requires a non-empty val split; "
                             "the current config assigns 0 frames to val.")
        sums: Dict[str, float] = {}
        counts: Dict[str, float] = {}
        n_frames = 0.0
        self.model.eval()
        try:
            for batch in self.loaders["val"]:
                dev = self._to_device(batch)
                bsz = int(next(iter(dev.values())).shape[0])
                valid = np.asarray(batch.get("valid", np.ones(bsz)),
                                   np.float64)
                metrics = eval_step(self.cfg, unwrap(self.model), dev)
                for k, v in metrics.items():
                    v = v.double().cpu().numpy()
                    finite = np.isfinite(v)
                    sums[k] = sums.get(k, 0.0) + float(
                        np.sum(np.where(finite, v, 0.0) * valid))
                    counts[k] = counts.get(k, 0.0) + float(
                        np.sum(valid * finite))
                n_frames += float(valid.sum())
        finally:
            self.model.train()
        if n_frames == 0:
            return {"loss": float("nan"), "rmse_m": float("nan")}
        agg = {k: (sums[k] / counts[k] if counts[k] else float("nan"))
               for k in sums}
        self.val_steps += 1
        self.writer.scalars(agg, self.val_steps, prefix="val/")
        return agg

    def train(self) -> float:
        """Train from ``start_epoch``; returns the best validation loss."""
        self._preempted = False
        if (self.cfg.train.graceful_preemption
                and self._preempt_monitor is None
                and threading.current_thread() is threading.main_thread()):
            self._preempt_monitor = _PreemptionMonitor()
        try:
            return self._train_loop()
        finally:
            if self._preempt_monitor is not None:
                self._preempt_monitor.restore()
                self._preempt_monitor = None

    def _train_loop(self) -> float:
        cfg = self.cfg
        best_eval = float("inf")
        patience = 0
        stop_after = cfg.train.stop_after or max(1, self.num_epochs - 4)
        steps_per_epoch = max(
            1, len(self.loaders["train"]) // cfg.train.update_interval)
        for epoch in range(self.start_epoch, self.num_epochs):
            skip = (max(0, self.training_steps - epoch * steps_per_epoch)
                    if epoch == self.start_epoch else 0)
            self.train_one_epoch(epoch, skip_opt_steps=skip)
            if self._preempted:
                state = self.state()
                if self._primary:
                    path = ckpt_util.save_preemption_checkpoint(
                        self.run_dir, state, epoch)
                    print(f"#### SIGTERM: saved preemption checkpoint to "
                          f"{path} (step {self.training_steps}); rerun with "
                          "auto-resume to continue")
                multihost.sync()
                break
            val = self.evaluate()
            val_loss = multihost.broadcast_value(val["loss"])
            self._say(f"#### epoch {epoch + 1}: val loss {val_loss:.5f} "
                      f"RMSE {val.get('rmse_m', float('nan')):.3f} m")
            if val_loss < best_eval:
                best_eval = val_loss
                patience = 0
                if cfg.train.save_model:
                    self._save_best(epoch, best_eval)
            else:
                patience += 1
            if patience >= cfg.train.early_stopping_thresh:
                self._say("#### early stopping")
                break
            if epoch + 1 >= stop_after:
                # the reference skips the final low-lr epochs
                self._say("#### stop_after reached")
                break
        if self._async_saver is not None:
            self._async_saver.close()
            self._async_saver = None
        self.writer.close()
        multihost.sync()
        return best_eval

    def _save_best(self, epoch: int, best_eval: float) -> None:
        """The best-validation checkpoint, gathered from every rank and
        written by the primary."""
        state = self.state()
        if self._primary:
            if self.cfg.train.async_checkpoint:
                if self._async_saver is None:
                    self._async_saver = ckpt_util.AsyncSaver()
                path = self._async_saver.save(self.run_dir, state, epoch,
                                              best_eval)
            else:
                path = ckpt_util.save_checkpoint(self.run_dir, state, epoch,
                                                 best_eval)
            print(f"#### saved best checkpoint to {path}")
        multihost.sync()
