"""Training checkpoints with the JAX package's names and resume rules.

Counterpart of ``camradepth_tpu/utils/checkpoint.py:21-181`` in torch. A
checkpoint is one ``.pth`` file holding ``{"state_dict": the fp32 model
state_dict in the reference key layout, "optimizer": the optimizer's
state_dict, "step": the optimizer step count}``, so ``load_engine``,
``cli test`` and ``cli serve`` take it as they take a reference ``.pth``.
Names:

- ``ckpt_epoch_<e>_loss_<l>.pth``, e = epochs completed, on a new best
  validation loss (runner.py:366-373);
- ``ckpt_preempt_epoch_<e>_step_<s>.pth``, the graceful-shutdown save
  after a SIGTERM: e epochs completed and s optimizer steps, so
  auto-resume restarts the interrupted epoch and skips what it consumed.

:func:`latest_checkpoint` orders them as the JAX package does (on equal
epochs the preempt save is newer; of two preempt saves the higher step);
:func:`best_checkpoint` takes the lowest loss. Files appear atomically
(written under a temporary name, then renamed), so neither ever sees a
partial write. :class:`AsyncSaver` writes on a thread.
"""

from __future__ import annotations

import os
import re
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

_REGULAR = re.compile(r"ckpt_epoch_(\d+)_loss_([\d.]+|nan|inf)$")
_PREEMPT = re.compile(r"ckpt_preempt_epoch_(\d+)_step_(\d+)$")


def _stem(p: Path) -> str:
    return p.name[:-4] if p.name.endswith(".pth") else p.name


def host_snapshot(model: torch.nn.Module, optimizer, step: int) -> Dict:
    """The training state as host tensors, copied now (the training loop
    may go on updating the live tensors while the copy is written)."""
    def host(tree):
        if torch.is_tensor(tree):
            return tree.detach().to("cpu", copy=True)
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(host(v) for v in tree)
        return tree

    state = {"state_dict": host(model.state_dict()), "step": int(step)}
    if optimizer is not None:
        state["optimizer"] = host(optimizer.state_dict())
    return state


def _write(path: Path, state: Dict) -> Path:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def checkpoint_path(run_dir, epoch: int, eval_loss: float) -> Path:
    """``ckpt_epoch_<epoch + 1>_loss_<eval_loss>.pth`` in ``run_dir``."""
    return Path(run_dir).resolve() / (
        f"ckpt_epoch_{epoch + 1}_loss_{eval_loss:.7f}.pth")


def save_checkpoint(run_dir, state: Dict, epoch: int,
                    eval_loss: float) -> Path:
    """Write a best-validation checkpoint (``state`` from
    :func:`host_snapshot`)."""
    return _write(checkpoint_path(run_dir, epoch, eval_loss), state)


def save_preemption_checkpoint(run_dir, state: Dict,
                               epochs_completed: int) -> Path:
    """The mid-epoch save after a SIGTERM; a later save of the same step
    replaces it."""
    return _write(Path(run_dir).resolve() / (
        f"ckpt_preempt_epoch_{epochs_completed}_step_{state['step']}.pth"),
        state)


class AsyncSaver:
    """Checkpoint writes on a background thread: ``save`` takes the host
    snapshot it is given and returns at once; a second save waits for
    the first. Call :meth:`wait` (or :meth:`close`) before reading the
    newest checkpoint or exiting; a failed write raises there."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, run_dir, state: Dict, epoch: int,
             eval_loss: float) -> Path:
        self.wait()
        path = checkpoint_path(run_dir, epoch, eval_loss)

        def work():
            try:
                _write(path, state)
            except BaseException as e:  # noqa: BLE001 — raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="checkpoint_writer")
        self._thread.start()
        return path

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()


def _checkpoints(run_dir) -> List[Tuple[Path, re.Match, bool]]:
    out = []
    for p in Path(run_dir).glob("ckpt_*epoch_*"):
        stem = _stem(p)
        m = _REGULAR.match(stem)
        if m:
            out.append((p, m, False))
            continue
        m = _PREEMPT.match(stem)
        if m:
            out.append((p, m, True))
    return out


def latest_checkpoint(run_dir) -> Optional[Path]:
    """The newest checkpoint in a run directory: by epochs completed; on
    an equal count a preempt save (it also holds part of the next epoch);
    of two preempt saves the higher step."""
    best, best_key = None, (-1, -1, -1)
    for p, m, preempt in _checkpoints(run_dir):
        key = ((int(m.group(1)), 1, int(m.group(2))) if preempt
               else (int(m.group(1)), 0, 0))
        if key > best_key:
            best, best_key = p, key
    return best


def best_checkpoint(run_dir) -> Optional[Path]:
    """The lowest-loss regular checkpoint in a run directory (a preempt
    save has no loss in its name and is never picked)."""
    best, best_loss = None, float("inf")
    for p, m, preempt in _checkpoints(run_dir):
        if preempt:
            continue
        loss = float(m.group(2))
        if loss < best_loss:
            best, best_loss = p, loss
    return best


def epochs_completed(path) -> int:
    """The epoch count a checkpoint's name records (both name forms)."""
    m = re.match(r"ckpt_(?:preempt_)?epoch_(\d+)_", Path(path).name)
    return int(m.group(1)) if m else 0


def restore_checkpoint(path) -> Dict:
    """Read a checkpoint written by this module (host tensors)."""
    return torch.load(path, map_location="cpu", weights_only=True)


class Restored(NamedTuple):
    """What :func:`partial_restore` did: the keys it copied and the
    (key, reason) pairs it left at their values."""

    transferred: List[str]
    skipped: List[Tuple[str, str]]

    @property
    def total(self) -> int:
        return len(self.transferred) + len(self.skipped)


def partial_restore(saved: Dict[str, torch.Tensor], model: torch.nn.Module,
                    verbose: bool = True) -> Restored:
    """Shape-matching partial load into ``model`` (reference
    load_checkpoint_with_shape_match, utils.py:352-370): the keys of
    ``saved`` with the model's shapes are copied into the model's own
    tensors, every other tensor keeps its value. ``len(transferred)`` of
    ``total`` is the count the JAX warm start prints. The model never
    holds a tensor of ``saved``: ``load_state_dict`` copies values into
    the model's storage (the JAX package once warm-started a student
    whose arrays aliased its teacher's)."""
    saved = {k.removeprefix("module."): v for k, v in saved.items()}
    own = model.state_dict()
    take, skipped = {}, []
    for key, value in own.items():
        if key in saved and tuple(saved[key].shape) == tuple(value.shape):
            take[key] = saved[key]
        else:
            reason = ("missing" if key not in saved else
                      f"shape {tuple(saved[key].shape)} vs "
                      f"{tuple(value.shape)}")
            skipped.append((key, reason))
    model.load_state_dict(take, strict=False)
    if verbose:
        for key, reason in skipped:
            print(f"#### partial restore: keeping init for {key} ({reason})")
    return Restored(sorted(take), skipped)
