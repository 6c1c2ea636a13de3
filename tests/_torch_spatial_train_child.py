"""One rank of tests/test_torch_spatial_train.py's gloo group (CPU, fp32),
forked by tests/torch_ranks.py:

    python tests/torch_ranks.py tests._torch_spatial_train_child 2
        <in_dir> <out_dir> <port> <cli_port>

``in_dir`` holds what the module writes while the ranks start,
``spec.json`` last: the JAX-initialised weights of tiny ``base``
(``jax_base.pth``), the microbatch they are held to JAX on
(``jax_micro.npz``) and the flags of the ranks' ``cli train``. The rank
joins a gloo group of two ranks at ``port``, takes the sp = 2 layout
(``Layout(sp=2)``: every rank the whole batch, its rows of every 96-row
image, 2 and 1 at /32) and runs against the port's single-process step,
which each rank computes itself:

  1. two optimizer steps (2 microbatches of 2, dropout on, the GT of the
     last rank's rows at most 10 % valid) of tiny ``base`` and of tiny
     ``sup_unsup_seg`` + ``tpu_decoder`` (both focal CE terms on, the last
     rank's labels 95 % ignored), recording every guidance map's logits
     of both runs (``CamRaDepth._guidance``'s inputs, this rank's rows);
  2. ``grad_parity`` on the layout;
  3. one distill step: a ``sup_unsup_seg`` teacher into a ``sup_unsup_seg``
     + ``tpu_decoder`` student, teacher and student sharded;
     the ranks share the single-process references of 1 and 3, each
     computing some and broadcasting them;
  4. the loss and the summed gradients of one sp = 2 microbatch of the
     JAX-initialised ``base`` (dropout off), for the module to hold to the
     JAX package's;
  5. then, in a new group, ``cli train --spatial-parallel 2 --coordinator``
     over the module's corpus.

Writes ``rank<rank>.json`` into ``out_dir``, and on rank 0
``jax_grads.npz``.
"""

import sys
from pathlib import Path

# the metric writer would import TensorBoard, which pulls in TensorFlow
# here (~17 s); it then writes its JSONL alone
sys.modules["tensorboard"] = None

import dataclasses  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from camradepth_tpu_torch import cli  # noqa: E402
from camradepth_tpu_torch.models import camradepth  # noqa: E402
from camradepth_tpu_torch.models.camradepth import create_model  # noqa: E402
from camradepth_tpu_torch.parallel import gradcheck as gc  # noqa: E402
from camradepth_tpu_torch.parallel import multihost, spatial  # noqa: E402
from camradepth_tpu_torch.parallel.mesh import (  # noqa: E402
    Layout,
    sum_over_ranks,
    wrap,
)
from camradepth_tpu_torch.train.distill import distill_loss  # noqa: E402
from camradepth_tpu_torch.train.step import microbatch_loss  # noqa: E402

# the seed of the seg step's and the distill step's microbatches: one at
# which no guidance pixel of either rank lies near a tie (the module
# checks the margin). Of seeds 1-30, 16, 17 and 27 qualify on both ranks
# for both steps; 16 has the widest margins (2.9e-6 at the least)
SEG_SEED = 16
REPORT = ("loss_rel", "grad_norm_rel", "grad_rel", "grad_worst",
          "params_rel", "param_rel", "param_worst", "param_max_change_lr",
          "metrics")


class GuidanceLog:
    """The logits of every guidance map (``CamRaDepth._guidance``'s
    inputs) in call order: the single-process run's whole, the sharded
    run's this rank's rows, with the rows they hold."""

    def __init__(self):
        self.whole, self.rows = [], []

    def __enter__(self):
        self.saved = camradepth.CamRaDepth._guidance
        log = self

        def guidance(model, logits, unsup, dtype):
            shard = spatial.active()
            maps = [v.to(dtype).float().detach().numpy()
                    for v in (logits, unsup) if v is not None]
            if shard is None:
                log.whole.append(maps)
            else:
                sizes = shard.level_sizes(maps[0].shape[1])
                start = sum(sizes[:shard.index])
                log.rows.append((slice(start, start + sizes[shard.index]),
                                 maps))
            return log.saved(model, logits, unsup, dtype)

        camradepth.CamRaDepth._guidance = guidance
        return self

    def __exit__(self, *exc):
        camradepth.CamRaDepth._guidance = self.saved

    def margin(self, classes):
        """The smallest (gap - 2 x diff) of any guidance pixel: its two
        largest single-process logits' gap against twice the largest
        difference of its sharded logits from them (> 0: no argmax can
        flip), and how many maps were compared."""
        assert len(self.whole) == len(self.rows) > 0
        worst = np.inf
        for whole, (rows, maps) in zip(self.whole, self.rows):
            for w, g, n in zip(whole, maps, classes):
                w = w[:, rows]
                top2 = np.sort(w.reshape(*w.shape[:-1], -1, n), -1)[..., -2:]
                gap = top2[..., 1] - top2[..., 0]
                diff = np.abs(g - w).reshape(*gap.shape, n).max(-1)
                worst = min(worst, float((gap - 2 * diff).min()))
        return worst, len(self.rows)


def seg_config(tpu_decoder=True):
    cfg = gc.check_config(dropout=True, hw=gc.SP_HW, supervised_seg=True,
                          unsupervised_seg=True, tpu_decoder=tpu_decoder)
    return cfg.replace(train=dataclasses.replace(cfg.train,
                                                 seg_inter_loss=True))


def runs():
    """name -> (config, microbatches, optimizer steps, loss_fn) of the
    three step checks."""
    base = gc.check_config(dropout=True, hw=gc.SP_HW)
    seg = seg_config()
    teacher = create_model(seg_config(tpu_decoder=False).model, device="cpu",
                           seed=3)
    for p in teacher.parameters():
        p.requires_grad_(False)
    distill = functools.partial(distill_loss, teacher=teacher, alpha=0.5,
                                temperature=2.0)
    return {
        "base": (base, gc.parity_microbatches(base, 2, 2, seed=7, ranks=2,
                                              image_rows=True), 2,
                 microbatch_loss),
        "seg_tpu": (seg, gc.parity_microbatches(
            seg, 2, 2, seed=SEG_SEED, ranks=2, image_rows=True), 2,
            microbatch_loss),
        "distill": (seg, gc.parity_microbatches(
            seg, 2, 2, seed=SEG_SEED, ranks=2, image_rows=True), 1,
            distill)}


# which rank computes each run's single-process reference (the ranks
# share the work and then each other's references)
OWNER = {"base": 0, "distill": 0, "seg_tpu": 1}


def references(rank, checks):
    """name -> (the single-process model after the run's steps, its
    metrics, the guidance logits of its forwards): each rank computes its
    share (:data:`OWNER`) and broadcasts it."""
    mine = {}
    for name, (cfg, mbs, n, loss_fn) in checks.items():
        if OWNER[name] == rank:
            with GuidanceLog() as log:
                model, metrics = gc.reference_steps(cfg, mbs, n,
                                                    loss_fn=loss_fn)
            mine[name] = ({k: (p.detach(), p.grad)
                           for k, p in model.named_parameters()}, metrics,
                          log.whole)
    out = {}
    for name, (cfg, _, _, _) in checks.items():
        pack = [mine.get(name)]
        dist.broadcast_object_list(pack, src=OWNER[name])
        params, metrics, whole = pack[0]
        model = create_model(cfg.model, device="cpu", train=True)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(params[k][0])
                p.grad = params[k][1]
        out[name] = (model, metrics, whole)
    return out


def steps(layout, rank, out):
    """1. the base and seg steps; 2. grad_parity; 3. the distill step:
    each against the single-process reference of :func:`references`."""
    checks = runs()
    refs = references(rank, checks)
    for name, (cfg, mbs, n, loss_fn) in checks.items():
        model, metrics, whole = refs[name]
        with GuidanceLog() as log:
            r = gc.step_parity(layout, cfg, mbs, steps=n, loss_fn=loss_fn,
                               reference=(model, metrics))
        out[name] = {k: r[k] for k in REPORT}
        if whole:
            log.whole = whole
            out[f"{name}_ties"] = log.margin((cfg.model.num_classes,
                                              cfg.model.unsup_classes))
    out["grad_parity"] = gc.grad_parity(layout)


def jax_gradients(layout, in_dir, out_dir, rank, out):
    """4. the sp = 2 loss and summed gradients of the JAX-initialised
    tiny base on one microbatch, dropout off."""
    cfg = gc.check_config(hw=gc.SP_HW)
    state = torch.load(in_dir / "jax_base.pth")["state_dict"]
    micro = {k: torch.from_numpy(v)
             for k, v in np.load(in_dir / "jax_micro.npz").items()}
    model = wrap(create_model(cfg.model, device="cpu", state_dict=state,
                              train=True), layout)
    loss, _ = microbatch_loss(cfg, model, micro)
    loss.backward()
    named = [(n, p) for n, p in model.named_parameters()
             if p.grad is not None]
    sum_over_ranks([p.grad for _, p in named])
    out["jax_loss"] = float(loss.detach())
    if rank == 0:
        np.savez(out_dir / "jax_grads.npz",
                 **{n: p.grad.numpy() for n, p in named})


def main(rank, world, argv):
    # below the test workers' priority, as tests/_torch_spatial_child.py
    os.nice(10)
    torch.set_num_threads(1)
    in_dir, out_dir = Path(argv[0]), Path(argv[1])
    port, cli_port = int(argv[2]), int(argv[3])
    out, seconds = {}, {}
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    layout = Layout(sp=world)
    t0 = time.perf_counter()
    steps(layout, rank, out)
    seconds["steps"] = time.perf_counter() - t0
    # the module writes spec.json last, while the steps run
    for _ in range(6000):
        if (in_dir / "spec.json").exists():
            break
        time.sleep(0.05)
    spec = json.loads((in_dir / "spec.json").read_text())
    t1 = time.perf_counter()
    jax_gradients(layout, in_dir, out_dir, rank, out)
    multihost.shutdown()
    out["cli_rc"] = cli.main(
        ["train", "--coordinator", f"127.0.0.1:{cli_port}",
         "--num-processes", str(world), "--process-id", str(rank),
         "--spatial-parallel", str(world), "--run-dir",
         str(out_dir / "run")] + spec["train_flags"])
    seconds["jax_and_cli"] = time.perf_counter() - t1
    out["seconds"] = seconds
    (out_dir / f"rank{rank}.json").write_text(json.dumps(out))
    print(f"[{rank}] DONE", flush=True)
