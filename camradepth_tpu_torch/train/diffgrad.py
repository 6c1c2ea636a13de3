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
"""

from __future__ import annotations

import torch


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
            for p in group["params"]:
                # a parameter the loss does not reach has a zero gradient,
                # as in the JAX package
                g = (p.grad if p.grad is not None
                     else torch.zeros_like(p)).float()
                if wd:
                    g = g + wd * p.float()
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.int64)
                    state["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=torch.float32)
                    state["previous_grad"] = torch.zeros_like(
                        p, dtype=torch.float32)
                    state["exp_grad_norm"] = torch.zeros(
                        (), dtype=torch.float32, device=p.device)
                state["step"] += 1
                t = float(state["step"])
                gn = torch.linalg.vector_norm(g)
                egn = 0.95 * state["exp_grad_norm"] + 0.05 * gn
                g1 = torch.where(egn > gn, g * egn / (gn + 1e-8), g)
                m = b1 * state["exp_avg"] + (1 - b1) * g1
                v = b2 * state["exp_avg_sq"] + (1 - b2) * torch.square(g)
                bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** t
                bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** t
                step_size = (torch.sqrt(bc2) / (bc1 + 1e-8)).to(p.device)
                dfc = torch.sigmoid(torch.abs(state["previous_grad"] - g))
                direction = step_size * (m * dfc) / (torch.sqrt(v) + eps)
                p.add_((-lr * direction).to(p.dtype))
                state["exp_avg"] = m
                state["exp_avg_sq"] = v
                state["previous_grad"] = g
                state["exp_grad_norm"] = egn
        return loss
