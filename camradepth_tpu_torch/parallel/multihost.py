"""Multi-process runs: the process group, this rank's share of the work, and
the host-side rules that keep one writer.

Counterpart of ``camradepth_tpu/parallel/multihost.py``. Every process runs
the same program on one device; ``torch.distributed`` joins them:

- :func:`initialize` starts the process group before any model is built,
  from an explicit coordinator (``tcp://``) or from ``torchrun``'s
  environment (``env://``). The backend is NCCL for a CUDA device and gloo
  for the CPU, or gloo on cards that the host's ranks outnumber: ranks
  that share a card, which NCCL refuses. Nothing falls back: a failed
  start raises.
- :func:`grid_groups` builds the row and column sub-groups of a rank grid
  (a serving mesh's ``sp`` and ``data`` groups).
- :func:`process_rows` is this rank's contiguous rows of a global batch;
  the trainer's loaders take the strided rows instead
  (``data/pipeline.make_loaders(process_shard=...)``).
- :class:`BatchShard` is this rank's rows of a microbatch that spans the
  ranks: the losses sum their normalizers over it, so every masked mean is
  the global batch's (``train/losses.py``).
- :func:`full_state` is the counterpart of ``replicated_host_tree``: the
  full fp32 model and optimizer state, gathered from the DDP replica or
  the FSDP2 shards, in the single-device checkpoint layout;
  :func:`load_full_state` puts such a state into any layout.
- :func:`any_flag`, :func:`broadcast_value` and :func:`sync` keep host
  decisions (preemption, the best checkpoint, early stopping) the same on
  every rank.

Without a process group each helper is its one-process answer, so callers
use them unconditionally.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (an FSDP2 shard). A process that never
    imported ``torch.distributed.tensor`` holds none, so the check does
    not import it (~1.5 s) on the single-device path."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> None:
    """Join the process group; call before any model is built.

    ``coordinator`` ("host:port") needs ``num_processes`` and
    ``process_id`` and starts ``tcp://``; with none of the three the
    group starts from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). On a CUDA device
    each rank takes the card ``LOCAL_RANK`` names (else its rank modulo
    the cards present) and the backend is NCCL, unless the ranks on this
    host (:func:`_local_ranks`) outnumber its cards: ranks that share a
    card, which NCCL refuses, start gloo, whose collectives go through the
    host (:func:`collective_device`). On the CPU it is gloo."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    if coordinator is None:
        if num_processes is not None or process_id is not None:
            raise ValueError("--num-processes and --process-id need "
                             "--coordinator")
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise ValueError(
                f"--multihost starts from torchrun's environment, which "
                f"lacks {', '.join(missing)}: launch with torchrun "
                "--nproc-per-node N, or pass --coordinator HOST:PORT "
                "--num-processes N --process-id I")
        init, kw = "env://", {}
        rank = int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError(
                "--coordinator requires --num-processes and --process-id")
        init = f"tcp://{coordinator}"
        kw = dict(world_size=int(num_processes), rank=int(process_id))
        rank = int(process_id)
    dev = torch.device(device)
    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        local = dev.index if dev.index is not None else int(
            os.environ.get("LOCAL_RANK", rank % cards))
        torch.cuda.set_device(local)
        if _local_ranks(coordinator, num_processes) <= cards:
            backend = "nccl"
    dist.init_process_group(backend, init_method=init, **kw)


def _local_ranks(coordinator: Optional[str],
                 num_processes: Optional[int]) -> int:
    """The ranks on this host: ``LOCAL_WORLD_SIZE`` (torchrun sets it),
    else all ``num_processes`` when the coordinator is a loopback address,
    else one."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    host = (coordinator or "").rsplit(":", 1)[0].strip("[]")
    if host in ("127.0.0.1", "localhost", "::1"):
        return int(num_processes or 1)
    return 1


def shutdown() -> None:
    """Leave the process group (every rank, at the end of a run)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_multiprocess() -> bool:
    return process_count() > 1


def is_primary() -> bool:
    """True on the process that owns the run directory's files (metrics,
    config, snapshot, checkpoints)."""
    return process_index() == 0


def process_rows(n_rows: int) -> range:
    """This rank's contiguous rows of a length-``n_rows`` global batch
    (``camradepth_tpu/parallel/multihost.py:161-176``); an uneven split
    raises."""
    pc, pi = process_count(), process_index()
    if n_rows % pc:
        raise ValueError(
            f"{n_rows} rows do not divide evenly over {pc} processes")
    per = n_rows // pc
    return range(pi * per, (pi + 1) * per)


def grid_groups(rows: int, cols: int):
    """The sub-groups of a ``rows`` x ``cols`` grid of the process group's
    ranks, rank = row * cols + col (row-major, as the JAX package lays out
    its ``(data, sp)`` mesh): (this rank's row, ``cols`` ranks; this rank's
    column, ``rows`` ranks). Every rank builds every group, in one order."""
    if rows * cols != process_count():
        raise ValueError(f"a {rows}x{cols} grid needs {rows * cols} ranks, "
                         f"the process group has {process_count()}")
    rank = process_index()
    mine = [None, None]
    for r in range(rows):
        g = dist.new_group([r * cols + c for c in range(cols)])
        if rank // cols == r:
            mine[0] = g
    for c in range(cols):
        g = dist.new_group([r * cols + c for r in range(rows)])
        if rank % cols == c:
            mine[1] = g
    return mine[0], mine[1]


def collective_device() -> torch.device:
    """The device of the tensors the group's backend reduces: this rank's
    card under NCCL, the CPU under gloo."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sync() -> None:
    """A barrier across the ranks (e.g. after the primary wrote a file
    that the others read)."""
    if is_multiprocess():
        dist.barrier()


def any_flag(flag: bool) -> bool:
    """True on every rank when any rank's ``flag`` is: one all-reduce, so
    every rank stops at the same step (the preemption check)."""
    if not is_multiprocess():
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_value(value: float) -> float:
    """The primary's ``value`` on every rank (fp64)."""
    if not is_multiprocess():
        return value
    t = torch.tensor([value], dtype=torch.float64,
                     device=collective_device())
    dist.broadcast(t, src=0)
    return float(t.item())


class _SumAcrossRanks(torch.autograd.Function):
    """The sum of ``x`` over the ranks. Its backward hands the incoming
    gradient to this rank's ``x`` as it is: the sum's gradient with respect
    to each term, so the ranks' gradients add up to the global one."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad


@dataclass(frozen=True)
class BatchShard:
    """Rows ``[index * b, (index + 1) * b)`` of a global microbatch of
    ``count * b`` rows, one share per rank of the process group, as
    ``parallel/mesh.wrap`` lays the batch out."""

    index: int
    count: int

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, outside autograd."""
        out = t.detach().clone()
        dist.all_reduce(out)
        return out

    def sum_grad(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks; the gradient reaches each rank's
        ``t`` (see :class:`_SumAcrossRanks`)."""
        return _SumAcrossRanks.apply(t)


def _state_options(everywhere: bool):
    from torch.distributed.checkpoint.state_dict import StateDictOptions

    return StateDictOptions(full_state_dict=True,
                            cpu_offload=not everywhere)


def _param_names(model) -> list:
    from camradepth_tpu_torch.parallel.mesh import unwrap

    return [n for n, _ in unwrap(model).named_parameters()]


def full_state(model, optimizer=None, everywhere: bool = False
               ) -> Dict[str, Any]:
    """The full fp32 training state of a wrapped model (DDP, FSDP2 or
    HSDP) as host tensors: ``{"state_dict": reference-layout keys (no DDP
    ``module.`` prefix), "optimizer": optimizer.state_dict()'s layout
    (parameters numbered in ``model.parameters()`` order)}``, the layout a
    single-device checkpoint has. Every rank must call it: FSDP2 gathers
    its shards. On the primary only, unless ``everywhere``; the other
    ranks get empty dicts."""
    from torch.distributed.checkpoint.state_dict import (
        get_model_state_dict,
        get_optimizer_state_dict,
    )

    opts = _state_options(everywhere)
    sd = get_model_state_dict(model, options=opts)
    out = {"state_dict": {k: v.detach().to("cpu", copy=True)
                          for k, v in sd.items()}}
    if optimizer is not None:
        osd = get_optimizer_state_dict(model, optimizer, options=opts)
        if osd:
            order = [n for g in osd["param_groups"] for n in g["params"]]
            num = {n: i for i, n in enumerate(order)}
            osd = {"state": {num[n]: {k: v.detach().to("cpu", copy=True)
                                      if torch.is_tensor(v) else v
                                      for k, v in s.items()}
                             for n, s in osd["state"].items()},
                   "param_groups": [dict(g, params=[num[n]
                                                    for n in g["params"]])
                                    for g in osd["param_groups"]]}
        out["optimizer"] = osd
    return out


def load_full_state(model, optimizer, state: Dict[str, Any]) -> None:
    """Load a full state (:func:`full_state`'s layout, or a single-device
    checkpoint's) into a wrapped model and its optimizer; every rank
    passes the whole state."""
    from torch.distributed.checkpoint.state_dict import (
        set_model_state_dict,
        set_optimizer_state_dict,
    )

    opts = _state_options(True)
    set_model_state_dict(model, state["state_dict"], options=opts)
    if optimizer is not None and state.get("optimizer"):
        names = _param_names(model)
        osd = state["optimizer"]
        osd = {"state": {names[i]: s for i, s in osd["state"].items()},
               "param_groups": [dict(g, params=[names[i]
                                                for i in g["params"]])
                                for g in osd["param_groups"]]}
        set_optimizer_state_dict(model, optimizer, osd, options=opts)
