"""diffGradNorm as a ``torch.optim.Optimizer``.

Counterpart of ``camradepth_tpu/train/diffgrad.py:38-123`` (the reference
optimizer, diffGradNorm.py:41-113): Adam moments plus (a) AdaNorm's
gradient-norm correction, a per-tensor EMA of the gradient's L2 norm
(0.95 / 0.05) that scales a gradient whose norm is below the EMA up to it
(:81-88), and (b) diffGrad's friction coefficient dfc = sigmoid(|g_prev -
g|) that damps the first moment (:100-106). The JAX package's quirks are
kept:

- the norm correction is per tensor;
- ``exp_avg`` takes the corrected gradient, while ``exp_avg_sq``, ``dfc``
  and ``previous_grad`` take the raw one;
- step_size = sqrt(1 - b2**t) / (1 - b1**t + 1e-8), with no separate bias
  correction in the denominator;
- weight decay is coupled: added to the gradient before the rule;
- the learning rate is applied last: p -= lr * step_size * (m * dfc) /
  (sqrt(v) + eps).

All state is fp32: per tensor ``exp_avg``, ``exp_avg_sq``,
``previous_grad`` and the scalar ``exp_grad_norm``, plus the step count.
The learning rate is ``param_groups[i]["lr"]``, which the trainer sets
from the schedule before each step (the first step takes lr(0), as
optax's count does).

Under FSDP2 a parameter, its gradient and its ``exp_avg``, ``exp_avg_sq``
and ``previous_grad`` are DTensors sharded alike, and the update runs on
this rank's shards with the same operations. Only the per-tensor norm
needs the other ranks: it is the whole tensor's (a shard's own norm would
scale each shard by another factor), the shards' squared norms summed
over the ranks (one all-reduce per step for all of them), so
``exp_grad_norm`` stays a plain tensor, the same on every rank. Under DDP
every tensor is whole, as on one device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from camradepth_tpu_torch.parallel.multihost import is_dtensor


class DiffGradNorm(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        if lr < 0 or eps < 0 or weight_decay < 0:
            raise ValueError(f"invalid lr {lr}, eps {eps} or weight_decay "
                             f"{weight_decay}")
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, wd, lr = group["eps"], group["weight_decay"], group["lr"]
            params = group["params"]
            grads = [_gradient(p, wd) for p in params]
            for p, g, gn in zip(params, grads, _norms(params, grads)):
                self._update(p, g, gn, self.state[p], b1, b2, eps, lr)
        return loss

    @staticmethod
    def _update(p, g, gn, state, b1, b2, eps, lr) -> None:
        """One parameter's rule: ``g`` its (local) gradient with the weight
        decay, ``gn`` the whole tensor's norm of it."""
        if not state:
            state["step"] = torch.zeros((), dtype=torch.int64)
            state["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
            state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
            state["previous_grad"] = torch.zeros_like(p, dtype=torch.float32)
            state["exp_grad_norm"] = torch.zeros(
                (), dtype=torch.float32, device=p.device)
        sharded = p if is_dtensor(p) else None
        p = _local(p)
        exp_avg, exp_avg_sq, previous_grad = (
            _local(state[k]) for k in ("exp_avg", "exp_avg_sq",
                                       "previous_grad"))
        state["step"] += 1
        step_size = diffgrad_step_size(float(state["step"]), b1,
                                       b2).to(p.device)
        direction, m, v, egn = diffgrad_direction(
            g, gn, exp_avg, exp_avg_sq, previous_grad,
            state["exp_grad_norm"], step_size, b1, b2, eps)
        p.add_((-lr * direction).to(p.dtype))
        state["exp_avg"] = _like(m, sharded)
        state["exp_avg_sq"] = _like(v, sharded)
        state["previous_grad"] = _like(g, sharded)
        state["exp_grad_norm"] = egn


def diffgrad_step_size(t: float, b1: float, b2: float) -> torch.Tensor:
    """sqrt(1 - b2**t) / (1 - b1**t + 1e-8) for step count ``t``, in fp32,
    a 0-d tensor on the CPU."""
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** t
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** t
    return torch.sqrt(bc2) / (bc1 + 1e-8)


def diffgrad_direction(g, gn, exp_avg, exp_avg_sq, previous_grad,
                       exp_grad_norm, step_size, b1: float, b2: float,
                       eps: float):
    """The rule without its learning rate, shared by :class:`DiffGradNorm`
    and the vmapped search's trial step (``train/search.py``): for the fp32
    gradient ``g`` (weight decay added), its L2 norm ``gn`` and the state,
    returns (direction, exp_avg, exp_avg_sq, exp_grad_norm), the last three
    updated; the new ``previous_grad`` is ``g``. ``gn`` and
    ``exp_grad_norm`` broadcast against ``g``: 0-d for one tensor, one
    norm per trial ([T, 1, ...]) for a stack of trials."""
    egn = 0.95 * exp_grad_norm + 0.05 * gn
    g1 = torch.where(egn > gn, g * egn / (gn + 1e-8), g)
    m = b1 * exp_avg + (1 - b1) * g1
    v = b2 * exp_avg_sq + (1 - b2) * torch.square(g)
    dfc = torch.sigmoid(torch.abs(previous_grad - g))
    direction = step_size * (m * dfc) / (torch.sqrt(v) + eps)
    return direction, m, v, egn


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


def _gradient(p, wd: float) -> torch.Tensor:
    """The fp32 gradient with the coupled weight decay, of this rank's
    shard for a DTensor. A parameter the loss does not reach has a zero
    gradient, as in the JAX package."""
    grad = p.grad if p.grad is not None else torch.zeros_like(p)
    g = _local(grad).float()
    return g + wd * _local(p).float() if wd else g


def _shard_dims(p) -> list:
    """The mesh dimensions of more than one rank that shard ``p``."""
    if not is_dtensor(p):
        return []
    mesh = p.device_mesh
    return [d for d, pl in enumerate(p.placements)
            if pl.is_shard() and mesh.size(d) > 1]


def _norms(params, grads) -> list:
    """Each gradient's L2 norm, of the whole tensor: for sharded
    parameters (all on one mesh, as FSDP2 lays them out) the shards'
    squared norms are summed over the sharding ranks in one all-reduce."""
    norms = [torch.linalg.vector_norm(g) for g in grads]
    sharded = [i for i, p in enumerate(params) if _shard_dims(p)]
    if not sharded:
        return norms
    first = params[sharded[0]]
    mesh, dims = first.device_mesh, _shard_dims(first)
    if any(params[i].device_mesh != mesh or _shard_dims(params[i]) != dims
           for i in sharded):
        raise ValueError("sharded parameters of one mesh and placement only")
    sq = torch.stack([norms[i] for i in sharded]).square()
    for d in dims:
        dist.all_reduce(sq, group=mesh.get_group(d))
    for j, i in enumerate(sharded):
        norms[i] = sq[j].sqrt()
    return norms


def _like(local: torch.Tensor, sharded) -> torch.Tensor:
    """``local`` as a shard of a DTensor laid out like ``sharded``, or
    itself for a whole parameter."""
    if sharded is None:
        return local
    return type(sharded).from_local(
        local, sharded.device_mesh, sharded.placements, run_check=False,
        shape=sharded.shape, stride=sharded.stride())
