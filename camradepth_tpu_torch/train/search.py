"""Hyperparameter search: random, successive halving, and vmapped trials.

Counterpart of ``camradepth_tpu/train/search.py``. Configs are sampled
from typed search spaces with the JAX package's numpy draws (the same calls
on the same ``default_rng(seed)``, so the sampled trials are identical),
then either

- run as short budgeted trials one after another through the port's
  :class:`train.trainer.Trainer` (:func:`random_search`), pruned by
  successive halving (:func:`successive_halving_search`); or
- trained all at once (:func:`vmapped_trials`, :func:`vmapped_halving`):
  the parameters and the optimizer state of every trial are stacked on a
  leading trial axis, and one step runs the model's forward and backward
  for every trial under ``torch.func.vmap`` over ``torch.func.grad`` of a
  ``functional_call``. The Hopper kernels' vmap rules fold the trial axis
  into their batch axis (``ops/_build.register_vmap``), so each kernel
  launches once per call for all trials. Only ``learning_rate`` and
  ``weight_decay`` may differ between vmapped trials.

The vmapped trial step is the JAX package's ``_vmapped_machinery``
(``:205-299``), not ``train/step.py``: the gradients are averaged over the
``update_interval`` microbatches, the L2 is coupled (``g + wd * p``), the
diffGradNorm direction (``train/diffgrad.diffgrad_direction``) takes each
tensor's norm per trial, and the parameters move by ``lr * shape(step)``
times it, ``shape`` being the OneCycle schedule normalised to a peak of 1
over the run's total steps. Every trial sees the same data and the same
dropout masks (drawn once under ``randomness="same"``).

``shard_trials`` spreads the trial axis over the ranks of the process group
(``parallel/multihost``), the counterpart of the JAX ``mesh`` argument:
each rank trains its contiguous share of the trials and the val losses are
all-gathered in rank order, so every rank returns the same results. A
halving rung whose survivors do not divide over the ranks trains on every
rank (JAX's replication fallback).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from camradepth_tpu_torch import resolve_device
from camradepth_tpu_torch.config import ConfigError, ExperimentConfig
from camradepth_tpu_torch.data.wire import WIRE_KEYS

# the microbatch keys a vmapped trial step reads (the JAX trainer's
# _BATCH_KEYS)
_BATCH_KEYS = ("features", "gt_depth", "seg", "seg_inter") + WIRE_KEYS


def sample_config(
    search_spaces: Dict[str, Tuple[Sequence[Any], str]],
    rng: np.random.Generator,
) -> Dict[str, Any]:
    """Sample one assignment. Space modes (reference
    random_search_spaces_to_config, runner.py:523-547):
      'log'   - log-uniform over [lo, hi]
      'float' - uniform over [lo, hi]
      'int'   - uniform integer in [lo, hi)
      'item'  - uniform choice from the list
    Unknown modes, and a 'log' space that is not positive, are skipped."""
    out: Dict[str, Any] = {}
    for key, (rng_vals, mode) in search_spaces.items():
        if mode == "log":
            lo, hi = rng_vals[0], rng_vals[-1]
            if lo <= 0 or hi <= 0:
                continue
            out[key] = float(
                10 ** rng.uniform(math.log10(lo), math.log10(hi)))
        elif mode == "float":
            out[key] = float(rng.uniform(rng_vals[0], rng_vals[-1]))
        elif mode == "int":
            out[key] = int(rng.integers(rng_vals[0], rng_vals[-1]))
        elif mode == "item":
            out[key] = rng_vals[int(rng.integers(len(rng_vals)))]
    return out


def apply_overrides(cfg: ExperimentConfig, overrides: Dict[str, Any]
                    ) -> ExperimentConfig:
    """Route sampled values into the typed config (train.* by default,
    'model.xxx' / 'data.xxx' prefixes route to the other trees)."""
    train_kw, model_kw, data_kw = {}, {}, {}
    for k, v in overrides.items():
        if k.startswith("model."):
            model_kw[k[6:]] = v
        elif k.startswith("data."):
            data_kw[k[5:]] = v
        else:
            train_kw[k] = v
    if train_kw:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train_kw))
    if model_kw:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))
    if data_kw:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, **data_kw))
    return cfg


def _run_trial(cfg: ExperimentConfig, loaders, trial_runner, device) -> float:
    if trial_runner is not None:
        return float(trial_runner(cfg))
    from camradepth_tpu_torch.train.trainer import Trainer

    return float(Trainer(cfg, loaders=loaders, device=device).train())


def successive_halving_search(
    base_cfg: ExperimentConfig,
    search_spaces: Dict[str, Tuple[Sequence[Any], str]],
    num_trials: int = 9,
    min_steps: int = 10,
    max_steps: int = 200,
    eta: int = 3,
    seed: int = 0,
    loaders=None,
    trial_runner=None,
    device="cuda",
) -> Tuple[Dict[str, Any], float, List[Dict]]:
    """Random search with successive-halving pruning (Jamieson &
    Talwalkar, AISTATS 2016): every sampled config trains ``min_steps``
    optimizer steps; each rung keeps the best ceil(1/eta) fraction by val
    loss and multiplies the budget by ``eta``, until the budget would pass
    ``max_steps``. Each rung retrains its survivors from scratch through
    the Trainer. ``trial_runner(cfg) -> float`` replaces the Trainer run;
    the budget arrives as ``cfg.train.num_steps``."""
    rng = np.random.default_rng(seed)
    trials = [sample_config(search_spaces, rng) for _ in range(num_trials)]
    results: List[Dict] = []
    budget = max(1, min_steps)
    rung = 0
    while True:
        scored: List[Tuple[float, Dict[str, Any]]] = []
        for overrides in trials:
            cfg = apply_overrides(base_cfg, overrides)
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, num_steps=budget, num_epochs=None))
            val_loss = _run_trial(cfg, loaders, trial_runner, device)
            scored.append((val_loss, overrides))
            results.append({"overrides": overrides, "val_loss": val_loss,
                            "rung": rung, "steps": budget})
        scored.sort(key=lambda t: t[0])
        keep = max(1, math.ceil(len(scored) / eta))
        trials = [o for _, o in scored[:keep]]
        if budget * eta > max_steps:  # this was the largest-budget rung
            best_loss, best = scored[0]
            return best, best_loss, results
        budget *= eta
        rung += 1


def random_search(
    base_cfg: ExperimentConfig,
    search_spaces: Dict[str, Tuple[Sequence[Any], str]],
    num_trials: int = 50,
    seed: int = 0,
    loaders=None,
    trial_runner=None,
    device="cuda",
) -> Tuple[Dict[str, Any], float, List[Dict]]:
    """``num_trials`` short trainings; returns (best_overrides,
    best_val_loss, all_results). ``trial_runner(cfg) -> float`` replaces
    the Trainer run."""
    rng = np.random.default_rng(seed)
    results: List[Dict] = []
    best, best_loss = None, float("inf")
    for _ in range(num_trials):
        overrides = sample_config(search_spaces, rng)
        cfg = apply_overrides(base_cfg, overrides)
        val_loss = _run_trial(cfg, loaders, trial_runner, device)
        results.append({"overrides": overrides, "val_loss": val_loss})
        if val_loss < best_loss:
            best, best_loss = overrides, val_loss
    return best, best_loss, results


def batches_from_loader(loader, update_interval: int,
                        max_batches: int = 8) -> List[Dict[str, Any]]:
    """Group a loader's [B, ...] microbatches into the [update_interval, B,
    ...] optimizer-step stacks that the vmapped sweeps consume."""
    it = iter(loader)
    batches: List[Dict[str, Any]] = []
    mbs: List[Dict[str, Any]] = []
    try:
        while len(batches) < max_batches:
            b = next(it)
            mbs.append({k: np.asarray(b[k]) for k in _BATCH_KEYS
                        if k in b and b[k] is not None})
            if len(mbs) == update_interval:
                batches.append({k: np.stack([m[k] for m in mbs])
                                for k in mbs[0]})
                mbs = []
    except StopIteration:
        pass
    return batches


def _check_vmap_spaces(search_spaces) -> None:
    unsupported = {k for k in search_spaces
                   if k not in ("learning_rate", "weight_decay")}
    if unsupported:
        raise ValueError(
            "vmapped trials share one model graph; only optimizer "
            f"hyperparameters can vary, got {sorted(unsupported)} "
            "(use the sequential search paths for those)")


def _resolve_batches(batches, val_batch, loaders, update_interval):
    """The optimizer-step stacks and the val batch of a vmapped sweep, from
    ``batches`` or from the ``make_loaders`` dict (or any object with a
    ``.train`` loader)."""
    if batches is None:
        if loaders is None:
            raise ValueError("need batches or loaders")
        train_loader = (loaders["train"] if isinstance(loaders, dict)
                        else loaders.train)
        batches = batches_from_loader(train_loader, update_interval)
        if not batches:
            raise ValueError(
                "train split too small for one optimizer step "
                f"(need {update_interval} microbatches)")
        if val_batch is None and (isinstance(loaders, dict)
                                  and loaders.get("val") is not None):
            vb = next(iter(loaders["val"]))
            val_batch = {k: np.asarray(vb[k]) for k in _BATCH_KEYS
                         if k in vb and vb[k] is not None}
    return list(batches), val_batch


def check_vmappable(cfg: ExperimentConfig) -> None:
    """Refuse what cannot run under ``torch.func``: recomputation
    (``torch.utils.checkpoint``, the ``remat_*`` switches) has no
    ``vmap``/``grad`` support, so a vmapped sweep trains without it."""
    on = [f"model.{k}" for k in ("remat_encoder", "remat_decoder",
                                 "remat_decoder_small")
          if getattr(cfg.model, k)]
    if on:
        raise ConfigError(
            f"vmapped trials run under torch.func, which cannot recompute "
            f"activations (torch.utils.checkpoint): turn off "
            f"{', '.join(on)}, or use the sequential search")


def _trial_shape(t: torch.Tensor, n: int) -> Tuple[int, ...]:
    """The shape that broadcasts a [T] vector against a [T, ...] tensor."""
    return (t.shape[0],) + (1,) * (n - 1)


def _vmapped_machinery(cfg: ExperimentConfig, model, total_steps: int,
                       device):
    """The sweep core shared by :func:`vmapped_trials` and
    :func:`vmapped_halving`: ``v_step`` (one optimizer step of every trial),
    ``v_val`` (every trial's val loss) and ``make_state`` (the stacked
    parameters and optimizer state of ``num_trials`` copies of the model's
    current weights). The trial count is the leading dimension of the
    state, so a halving rung's smaller stack needs nothing rebuilt."""
    from torch.func import functional_call, grad_and_value, vmap

    from camradepth_tpu_torch.train.diffgrad import (
        diffgrad_direction,
        diffgrad_step_size,
    )
    from camradepth_tpu_torch.train.losses import multitask_loss
    from camradepth_tpu_torch.train.schedule import onecycle
    from camradepth_tpu_torch.train.step import build_gt

    tr = cfg.train
    b1, b2 = tr.betas
    shape_fn = onecycle(1.0, total_steps=total_steps,
                        pct_start=tr.pct_start, div_factor=tr.div_factor,
                        final_div_factor=tr.final_div_factor)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    # CamRaDepth draws its dropout from a generator; a hook model may have
    # no dropout to draw
    set_generator = getattr(model, "set_generator", lambda gen: None)

    def make_state(num_trials: int):
        weights = dict(model.named_parameters())
        params = {n: weights[n].detach().float().expand(
            num_trials, *weights[n].shape).clone() for n in names}
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
        opt = {"step": 0, "exp_avg": zeros(), "exp_avg_sq": zeros(),
               "previous_grad": zeros(),
               "exp_grad_norm": {n: p.new_zeros(_trial_shape(p, p.ndim))
                                 for n, p in params.items()}}
        return params, opt

    def loss_fn(params, features, gt):
        pred = functional_call(model, params, (features,))
        return multitask_loss(pred, gt, cfg)[0]

    trial_grads = vmap(grad_and_value(loss_fn), in_dims=(0, None, None),
                       randomness="same")

    def v_step(params, opt, lrs, wds, micro, generators, step_i: int):
        """One optimizer step of every trial on ``micro`` (tensors of
        [update_interval, B, ...] on the device), microbatch j's dropout
        drawn from ``generators[j]``; returns (params, opt, losses [T])."""
        accum = next(iter(micro.values())).shape[0]
        model.train()
        grads, loss_sum = None, 0.0
        for j in range(accum):
            mb = {k: v[j] for k, v in micro.items()}
            set_generator(generators[j])
            g, loss = trial_grads(params, mb["features"], build_gt(mb))
            grads = g if grads is None else {
                n: grads[n] + g[n] for n in names}
            loss_sum = loss_sum + loss
        set_generator(None)
        step = opt["step"] + 1
        step_size = diffgrad_step_size(float(step), b1, b2).to(lrs.device)
        scale = lrs * shape_fn(step_i)
        new_params, new_opt = {}, {"step": step, "exp_avg": {},
                                   "exp_avg_sq": {}, "previous_grad": {},
                                   "exp_grad_norm": {}}
        for n in names:
            p = params[n]
            bshape = _trial_shape(p, p.ndim)
            g = grads[n] / accum + wds.view(bshape) * p
            gn = torch.linalg.vector_norm(g.flatten(1), dim=1).view(bshape)
            d, m, v, egn = diffgrad_direction(
                g, gn, opt["exp_avg"][n], opt["exp_avg_sq"][n],
                opt["previous_grad"][n], opt["exp_grad_norm"][n], step_size,
                b1, b2, tr.eps)
            new_params[n] = (p - scale.view(bshape) * d).to(p.dtype)
            new_opt["exp_avg"][n] = m
            new_opt["exp_avg_sq"][n] = v
            new_opt["previous_grad"][n] = g
            new_opt["exp_grad_norm"][n] = egn
        return new_params, new_opt, loss_sum / accum

    def val_loss_fn(params, features, gt):
        pred = functional_call(model, params, (features,))
        return multitask_loss(pred, gt, cfg)[0]

    trial_val = vmap(val_loss_fn, in_dims=(0, None, None))

    @torch.no_grad()
    def v_val(params, batch):
        """Every trial's deterministic val loss on ``batch`` ([B, ...]
        tensors on the device): [T]."""
        model.eval()
        try:
            return trial_val(params, batch["features"], build_gt(batch))
        finally:
            model.train()

    return v_step, v_val, make_state


def _device_tree(tree, device):
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in tree.items()}


def _trial_step_generators(device, seed: int, step_i: int, accum: int):
    from camradepth_tpu_torch.train.trainer import step_generator

    return [step_generator(device, seed, 0, step_i, j) for j in range(accum)]


class _TrialShards:
    """Which of a rung's trials this rank trains: under ``shard_trials``
    a contiguous share of them when they divide over the ranks, else all
    of them (replicated); without it, all."""

    def __init__(self, enabled: bool):
        from camradepth_tpu_torch.parallel import multihost

        self.world = multihost.process_count() if enabled else 1
        self.rank = multihost.process_index() if enabled else 0

    def mine(self, n_alive: int) -> range:
        if self.world == 1 or n_alive % self.world:
            return range(n_alive)
        per = n_alive // self.world
        return range(self.rank * per, (self.rank + 1) * per)

    def gather(self, local: torch.Tensor, n_alive: int) -> np.ndarray:
        """Every trial's value, in trial order, on every rank."""
        vals = local.detach().double().cpu()
        if self.world == 1 or n_alive % self.world:
            return vals.numpy()
        import torch.distributed as dist

        from camradepth_tpu_torch.parallel import multihost

        dev = multihost.collective_device()
        parts = [torch.empty_like(vals, device=dev)
                 for _ in range(self.world)]
        dist.all_gather(parts, vals.to(dev))
        return torch.cat([p.cpu() for p in parts]).numpy()

    def regroup(self, state, n_alive: int, idx: Sequence[int]):
        """The stacked ``state`` (params, opt) of this rank's share of the
        survivors ``idx`` (indices into the rung's ``n_alive`` trials) under
        the next rung's layout; survivors held by other ranks come over in
        one broadcast each (a flat fp32 buffer of the trial's tensors)."""
        params, opt = state
        old, new = self.mine(n_alive), self.mine(len(idx))
        keys = [(None, n) for n in params] + [
            (k, n) for k in ("exp_avg", "exp_avg_sq", "previous_grad",
                             "exp_grad_norm") for n in opt[k]]

        def get(key):
            k, n = key
            return params[n] if k is None else opt[k][n]

        if len(old) == n_alive:  # every trial is here
            pick = torch.as_tensor([idx[j] for j in new], dtype=torch.long)
            stacked = {key: get(key)[pick.to(get(key).device)]
                       for key in keys}
        else:
            import torch.distributed as dist

            from camradepth_tpu_torch.parallel import multihost

            dev = multihost.collective_device()
            per = len(old)
            rows: Dict[int, Dict] = {}
            for j, i in enumerate(idx):
                src = i // per
                if src == self.rank:
                    flat = torch.cat([get(key)[i - old.start].float()
                                      .reshape(-1) for key in keys])
                else:
                    flat = torch.empty(
                        sum(get(key)[0].numel() for key in keys),
                        dtype=torch.float32)
                flat = flat.to(dev)
                dist.broadcast(flat, src=src)
                if j in new:
                    rows[j] = _split_flat(flat, keys, get)
            stacked = {key: torch.stack([rows[j][key] for j in new])
                       for key in keys}
        new_params = {n: stacked[(None, n)] for n in params}
        new_opt = {"step": opt["step"]}
        for k in ("exp_avg", "exp_avg_sq", "previous_grad", "exp_grad_norm"):
            new_opt[k] = {n: stacked[(k, n)] for n in opt[k]}
        return new_params, new_opt


def _split_flat(flat: torch.Tensor, keys, get) -> Dict:
    """One trial's tensors back out of its flat fp32 buffer, each on its
    device and in its dtype."""
    out, at = {}, 0
    for key in keys:
        ref = get(key)[0]
        n = ref.numel()
        out[key] = flat[at:at + n].view(ref.shape).to(ref.device, ref.dtype)
        at += n
    return out


def _sweep_setup(base_cfg, search_spaces, num_trials, seed, model, device,
                 total_steps):
    _check_vmap_spaces(search_spaces)
    rng_np = np.random.default_rng(seed)
    trials = [sample_config(search_spaces, rng_np)
              for _ in range(num_trials)]
    dev = resolve_device(device)
    tr = base_cfg.train
    lrs = torch.tensor([t.get("learning_rate", tr.learning_rate)
                        for t in trials], dtype=torch.float32, device=dev)
    wds = torch.tensor([t.get("weight_decay", tr.weight_decay)
                        for t in trials], dtype=torch.float32, device=dev)
    if model is None:
        from camradepth_tpu_torch.models.camradepth import create_model

        check_vmappable(base_cfg)
        model = create_model(base_cfg.model, device=dev, seed=tr.seed,
                             train=True)
    machinery = _vmapped_machinery(base_cfg, model, total_steps, dev)
    return trials, lrs, wds, dev, machinery


def _flat_val(last: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The last train stack flattened to one batch (the val fallback)."""
    return {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in last.items()}


def vmapped_trials(
    base_cfg: ExperimentConfig,
    search_spaces: Dict[str, Tuple[Sequence[Any], str]],
    num_trials: int = 8,
    num_steps: int = 50,
    seed: int = 0,
    batches=None,
    val_batch=None,
    loaders=None,
    shard_trials: bool = False,
    model=None,
    device="cuda",
) -> Tuple[Dict[str, Any], float, List[Dict]]:
    """All trials train at once, for ``num_steps`` optimizer steps each;
    returns (best_overrides, best_val_loss, results).

    ``batches``: optimizer-step stacks (dicts of [update_interval, B, ...]
    arrays), reused cyclically; every trial sees the same data.
    ``val_batch``: one dict of [B, ...] arrays for the ranking (default:
    the last train stack, flattened). ``loaders``: the source of both when
    ``batches`` is None (:func:`batches_from_loader`, and a val batch from
    the dict's ``val`` loader). ``shard_trials``: spread the trials over
    the process group's ranks (``num_trials`` must divide). ``model``: any
    ``nn.Module`` whose forward returns the prediction dict that
    ``multitask_loss`` reads, its current weights every trial's start
    (default: the config's CamRaDepth, drawn from ``train.seed`` as the
    Trainer draws it)."""
    trials, lrs, wds, dev, (v_step, v_val, make_state) = _sweep_setup(
        base_cfg, search_spaces, num_trials, seed, model, device, num_steps)
    shards = _TrialShards(shard_trials)
    if shards.world > 1 and num_trials % shards.world:
        raise ValueError(f"num_trials {num_trials} must divide over the "
                         f"{shards.world} ranks")
    mine = shards.mine(num_trials)
    params_t, opt_t = make_state(len(mine))
    lrs, wds = lrs[mine.start:mine.stop], wds[mine.start:mine.stop]
    tr = base_cfg.train
    batches, val_batch = _resolve_batches(batches, val_batch, loaders,
                                          tr.update_interval)
    last = None
    for i in range(num_steps):
        micro = _device_tree(batches[i % len(batches)], dev)
        last = micro
        gens = _trial_step_generators(dev, tr.seed, i,
                                      next(iter(micro.values())).shape[0])
        params_t, opt_t, _ = v_step(params_t, opt_t, lrs, wds, micro, gens,
                                    i)
    vb = _flat_val(last) if val_batch is None else _device_tree(val_batch,
                                                                dev)
    val = shards.gather(v_val(params_t, vb), num_trials)
    results = [{"overrides": t, "val_loss": float(v), "steps": num_steps}
               for t, v in zip(trials, val)]
    order = int(np.argmin(val))
    return trials[order], float(val[order]), results


def vmapped_halving(
    base_cfg: ExperimentConfig,
    search_spaces: Dict[str, Tuple[Sequence[Any], str]],
    num_trials: int = 9,
    min_steps: int = 10,
    max_steps: int = 200,
    eta: int = 3,
    seed: int = 0,
    batches=None,
    val_batch=None,
    loaders=None,
    shard_trials: bool = False,
    model=None,
    device="cuda",
) -> Tuple[Dict[str, Any], float, List[Dict]]:
    """Successive halving whose every rung trains its survivors at once;
    survivors continue from their parameters and optimizer state. Rung r's
    cumulative budget is ``min_steps * eta**r`` up to ``max_steps``; after
    each rung the best ceil(1/eta) fraction is gathered out of the stacked
    state by index. The OneCycle shape spans the last rung's budget, so the
    winner sees the whole cycle. A lone survivor trains on to the last
    budget. Arguments as :func:`vmapped_trials`."""
    targets = [max(1, min_steps)]
    while targets[-1] * eta <= max_steps:
        targets.append(targets[-1] * eta)
    trials, lrs_all, wds_all, dev, (v_step, v_val, make_state) = \
        _sweep_setup(base_cfg, search_spaces, num_trials, seed, model,
                     device, targets[-1])
    shards = _TrialShards(shard_trials)
    mine = shards.mine(num_trials)
    params_t, opt_t = make_state(len(mine))
    tr = base_cfg.train
    batches, val_batch = _resolve_batches(batches, val_batch, loaders,
                                          tr.update_interval)
    if val_batch is not None:
        val_batch = _device_tree(val_batch, dev)
    results: List[Dict] = []
    alive = list(range(num_trials))  # indices into the sampled trials
    step_i = 0
    last = None
    for rung, target in enumerate(targets):
        sel = [alive[j] for j in mine]
        lrs, wds = lrs_all[sel], wds_all[sel]
        while step_i < target:
            micro = _device_tree(batches[step_i % len(batches)], dev)
            last = micro
            gens = _trial_step_generators(
                dev, tr.seed, step_i, next(iter(micro.values())).shape[0])
            params_t, opt_t, _ = v_step(params_t, opt_t, lrs, wds, micro,
                                        gens, step_i)
            step_i += 1
        vb = val_batch if val_batch is not None else _flat_val(last)
        val = shards.gather(v_val(params_t, vb), len(alive))
        for i, v in zip(alive, val):
            results.append({"overrides": trials[i], "val_loss": float(v),
                            "rung": rung, "steps": target})
        if rung == len(targets) - 1:
            order = int(np.argmin(val))
            return trials[alive[order]], float(val[order]), results
        if len(alive) == 1:
            continue  # a lone survivor trains on to the last budget
        keep = max(1, math.ceil(len(alive) / eta))
        idx = [int(i) for i in np.argsort(val)[:keep]]
        params_t, opt_t = shards.regroup((params_t, opt_t), len(alive), idx)
        alive = [alive[i] for i in idx]
        mine = shards.mine(len(alive))
