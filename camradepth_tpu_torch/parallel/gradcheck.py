"""A training layout against the unsharded step, on the ranks themselves.

Counterpart of ``camradepth_tpu/parallel/gradcheck.py``. The failure it
looks for is the silent one: a layout whose forward is right but whose
gradients are not (a per-rank normalizer, a shard's norm taken for the
tensor's, a dropout mask drawn alike on every rank). Every rank of a
process group of ``layout.size`` ranks calls the same function; each
computes the single-process result on the whole batch itself, then the
layout's on its rows (``process_rows``), and gathers what it compares.

- :func:`grad_parity`: loss and per-parameter gradients of one microbatch
  of a tiny fp32 model, dropout off, as ``grad_parity`` returns them
  (``ok``, ``max_rel_diff``, ``bad_leaves``, ``loss_diff``).
- :func:`step_parity`: whole optimizer steps (``train_step``, diffGradNorm,
  accumulation over microbatches, dropout on), the gradients of the last
  step and the parameters after it.
- :func:`parity_microbatches`: inputs on which a wrong normalizer shows:
  the ranks' valid-GT counts far apart (the last rank's rows at most 10 %
  valid) and, for a seg preset, the last rank's labels mostly ignored.

Under the sp layout every rank takes the whole batch and runs its rows of
every image (``parallel/spatial.py``), at :data:`SP_HW`: 96 rows, 2 and 1
at /32, so the ranks' rows are uneven, and the last rank's image rows
hold the sparse GT and the ignored labels.

Run as a module, it checks one layout on one rank of a gloo group on the
CPU and prints its results as one JSON line::

    python -m camradepth_tpu_torch.parallel.gradcheck --coordinator \\
        127.0.0.1:PORT --num-processes 4 --process-id I --data 2 --fsdp 2
    python -m camradepth_tpu_torch.parallel.gradcheck --coordinator \\
        127.0.0.1:PORT --num-processes 2 --process-id I --sp 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from camradepth_tpu_torch.config import ExperimentConfig, tiny_test_config
from camradepth_tpu_torch.models.camradepth import create_model
from camradepth_tpu_torch.parallel import multihost
from camradepth_tpu_torch.parallel.mesh import Layout, sum_over_ranks, wrap
from camradepth_tpu_torch.train.diffgrad import DiffGradNorm
from camradepth_tpu_torch.train.step import microbatch_loss, train_step

# the image size of the checks' tiny model; under sp 96 rows, 2 and 1 at
# /32 on two ranks
CHECK_HW = (32, 64)
SP_HW = (96, 64)


def check_config(dropout: bool = False, hw=CHECK_HW,
                 **model_kw) -> ExperimentConfig:
    """``tiny_test_config`` at ``hw`` in fp32; with ``dropout`` the
    ModelConfig defaults (drop path 0.1, Dropout2d 0.2), else none."""
    cfg = tiny_test_config()
    rates = (dict(drop_path_rate=0.1, dropout_rate=0.2) if dropout
             else dict(drop_path_rate=0.0, dropout_rate=0.0))
    return cfg.replace(model=dataclasses.replace(
        cfg.model, img_size=tuple(hw), compute_dtype="float32", **rates,
        **model_kw))


def parity_microbatches(cfg: ExperimentConfig, n_micro: int, batch: int,
                        seed: int = 0, ranks: int = 2,
                        image_rows: bool = False) -> List[Dict]:
    """``n_micro`` global microbatches of ``batch`` rows (numpy, seeded).
    Of ``ranks`` equal shares the last one's GT is at most 10 % valid,
    the others' about 60 %; with a supervised seg branch the last share's
    labels are 95 % ignored (255), the others' 10 %. With ``image_rows``
    the shares are those of the sp partition of every image's rows
    instead (``spatial.partition``; uneven)."""
    from camradepth_tpu_torch.parallel.spatial import partition

    h, w = cfg.model.img_size
    rng = np.random.default_rng(seed)
    if image_rows:
        counts = partition(h, ranks)
        total = sum(counts)

        def last(hh):  # [1, hh, 1]: the last rank's rows of a level
            start = (total - counts[-1]) * hh // total
            return (np.arange(hh) >= start)[None, :, None]
    else:
        def last(hh):  # [batch, 1, 1]: the last rank's samples
            return (np.arange(batch) >= batch - batch // ranks)[:, None,
                                                                None]
    out = []
    for _ in range(n_micro):
        gt = rng.uniform(0.01, 1.0, (batch, h, w)).astype(np.float32)
        dense = np.where(last(h), 0.08, 0.6)
        gt *= rng.uniform(size=gt.shape) < dense
        micro = {"features": rng.standard_normal(
            (batch, h, w, cfg.model.input_channels)).astype(np.float32),
            "gt_depth": gt}
        if cfg.model.supervised_seg:
            for key, (hh, ww) in (("seg", (h, w)),
                                  ("seg_inter", (h // 2, w // 2))):
                lab = rng.integers(0, cfg.model.num_classes,
                                   (batch, hh, ww)).astype(np.int32)
                drop = np.where(last(hh), 0.95, 0.1)
                lab[rng.uniform(size=lab.shape) < drop] = 255
                micro[key] = lab
        out.append(micro)
    return out


def layout_rows(layout: Layout, batch: int):
    """The rows of a global batch this rank takes: all of them under sp
    (each rank then runs its rows of every image), else its share."""
    return (slice(None) if layout.kind == "sp"
            else multihost.process_rows(batch))


def _tensors(micro: Dict, rows, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(device)
            for k, v in micro.items()}


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (every rank calls it), else ``t``."""
    return t.full_tensor() if multihost.is_dtensor(t) else t


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def grad_parity(layout: Layout, cfg: Optional[ExperimentConfig] = None,
                batch: int = 4, rel_tol: float = 1e-3, device="cpu",
                seed: int = 0) -> Dict[str, object]:
    """Loss and gradients of one microbatch: unsharded against
    ``layout``. A parameter is bad when max |g_layout - g_ref| /
    max |g_ref| > ``rel_tol``."""
    sp = layout.kind == "sp"
    cfg = cfg or check_config(hw=SP_HW if sp else CHECK_HW)
    micro = parity_microbatches(cfg, 1, batch, seed, layout.size,
                                image_rows=sp)[0]
    ref = create_model(cfg.model, device=device, seed=seed, train=True)
    l0, _ = microbatch_loss(cfg, ref, _tensors(micro, slice(None), device))
    l0.backward()
    model = wrap(create_model(cfg.model, device=device, seed=seed,
                              train=True), layout)
    mine = _tensors(micro, layout_rows(layout, batch), device)
    l1, _ = microbatch_loss(cfg, model, mine)
    if sp:  # the ranks' terms, summed (parallel/mesh.py)
        l1.backward()
        sum_over_ranks([p.grad for p in model.parameters()
                        if p.grad is not None])
    else:
        (l1 * layout.size).backward()
    bad, worst = [], 0.0
    for (name, p0), p1 in zip(ref.named_parameters(), model.parameters()):
        g1 = _full(p1.grad).detach()
        rel = float((g1 - p0.grad).abs().max()) / (
            float(p0.grad.abs().max()) + 1e-12)
        worst = max(worst, rel)
        if rel > rel_tol:
            bad.append(name)
    return {"ok": not bad, "max_rel_diff": worst, "bad_leaves": bad,
            "loss_diff": abs(float(l1.detach()) - float(l0.detach()))}


def _gens(step: int, n: int, device) -> List[torch.Generator]:
    return [torch.Generator(device=device).manual_seed(1000 * step + j)
            for j in range(n)]


def _run_steps(cfg, model, microbatches, rows, steps, lr, device, loss_fn):
    """``steps`` train steps of ``model`` over ``rows`` of every
    microbatch: the metrics of each step (floats)."""
    opt = DiffGradNorm(model.parameters(), lr=lr)
    mbs = [_tensors(m, rows, device) for m in microbatches]
    return [{k: float(v) for k, v in train_step(
        cfg, model, opt, mbs, _gens(s, len(mbs), device), lr,
        loss_fn=loss_fn).items()} for s in range(steps)]


def reference_steps(cfg: ExperimentConfig, microbatches: List[Dict],
                    steps: int = 2, lr: float = 1e-3, device="cpu",
                    seed: int = 0, loss_fn: Callable = microbatch_loss):
    """The single-process side of :func:`step_parity`: the model after
    ``steps`` optimizer steps over the whole of every microbatch, and the
    metrics of each step."""
    ref = create_model(cfg.model, device=device, seed=seed, train=True)
    return ref, _run_steps(cfg, ref, microbatches, slice(None), steps, lr,
                           device, loss_fn)


def step_parity(layout: Layout, cfg: ExperimentConfig,
                microbatches: List[Dict], steps: int = 2, lr: float = 1e-3,
                device="cpu", seed: int = 0,
                loss_fn: Callable = microbatch_loss,
                reference=None) -> Dict[str, object]:
    """``steps`` optimizer steps, each over all of ``microbatches``
    (global, numpy), single-process (``reference``, else
    :func:`reference_steps` of the same arguments) against ``layout`` from
    the same weights (seed) and dropout generators. Returns the largest
    relative difference of the loss and of grad_norm over the steps; the
    largest relative L2 error of a parameter's gradient in the last step
    (and its name); after the steps, the relative L2 error of all
    parameters together, the worst parameter's (and its name) and the
    largest change of an element in units of ``lr``; and the layout's
    metrics of every step (floats, to compare across ranks).

    A parameter that starts at zero (a bias) is where roundoff shows most:
    diffGrad's update of an element whose gradient is small against
    ``eps`` is linear in it, so the summation-order roundoff of such an
    element's gradient moves the parameter by that share."""
    ref, want = reference or reference_steps(cfg, microbatches, steps, lr,
                                             device, seed)
    batch = next(iter(microbatches[0].values())).shape[0]
    model = wrap(create_model(cfg.model, device=device, seed=seed,
                              train=True), layout)
    got = _run_steps(cfg, model, microbatches, layout_rows(layout, batch),
                     steps, lr, device, loss_fn)

    def worst(pairs):
        errs = {name: _rel_l2(a, b) for name, a, b in pairs}
        name = max(errs, key=errs.get)
        return errs[name], name

    named = list(ref.named_parameters())
    grad_rel, grad_name = worst(
        (n, _full(p.grad).detach(), p0.grad)
        for (n, p0), p in zip(named, model.parameters()))
    after = [(n, _full(p).detach(), p0.detach())
             for (n, p0), p in zip(named, model.parameters())]
    param_rel, param_name = worst(after)
    params_rel = _rel_l2(torch.cat([a.flatten() for _, a, _ in after]),
                         torch.cat([b.flatten() for _, _, b in after]))
    max_change = max(float((a - b).abs().max()) for _, a, b in after) / lr

    def rel(key):
        return max(abs(g[key] - w[key]) / max(abs(w[key]), 1e-30)
                   for g, w in zip(got, want))

    return {"loss_rel": rel("loss"), "grad_norm_rel": rel("grad_norm"),
            "grad_rel": grad_rel, "grad_worst": grad_name,
            "params_rel": params_rel, "param_rel": param_rel,
            "param_worst": param_name, "param_max_change_lr": max_change,
            "metrics": got}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="check one training layout (data x fsdp, or sp) on "
                    "this rank of a gloo group on the CPU: grad_parity, "
                    "then two optimizer steps (uneven valid-GT counts, "
                    "dropout on) and a sup_unsup_seg step against the "
                    "single-process step")
    p.add_argument("--coordinator", required=True, metavar="HOST:PORT")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--data", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    multihost.initialize(args.coordinator, args.num_processes,
                         args.process_id, device="cpu")
    try:
        layout = Layout(args.data, args.fsdp, sp=args.sp)
        sp = layout.kind == "sp"
        hw = SP_HW if sp else CHECK_HW
        out = {"layout": f"{layout.kind} {layout.data}x{layout.fsdp}x"
                         f"{layout.sp}",
               "grad_parity": grad_parity(layout)}
        batch = 2 if sp else 2 * layout.size
        seg = check_config(dropout=True, hw=hw, supervised_seg=True,
                           unsupervised_seg=True)
        seg = seg.replace(train=dataclasses.replace(seg.train,
                                                    seg_inter_loss=True))
        for name, cfg in (("step", check_config(dropout=True, hw=hw)),
                          ("seg_step", seg)):
            r = step_parity(layout, cfg, parity_microbatches(
                cfg, 2, batch, seed=7, ranks=layout.size, image_rows=sp))
            out[name] = {k: r[k] for k in (
                "loss_rel", "grad_norm_rel", "grad_rel", "grad_worst",
                "params_rel", "param_rel", "param_worst",
                "param_max_change_lr")}
            out[name]["loss"] = [m["loss"] for m in r["metrics"]]
            out[name]["grad_norm"] = [m["grad_norm"] for m in r["metrics"]]
        print(json.dumps(out))
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
