"""The train step (microbatch gradient accumulation) and the eval step.

Counterpart of ``camradepth_tpu/train/step.py:34-217``. One optimizer step
consumes ``update_interval`` microbatches: each runs its forward and
backward (the gradients add up in ``.grad``), then the sum is divided by
the count, its global L2 norm is taken, and diffGradNorm takes one step.
Activations are in the compute dtype; the params, their gradients, the
optimizer state, the norms and the losses are fp32. The GT min-pool
pyramid is built on the device, so only the full-resolution inverse-depth
map comes from the host. A compact wire microbatch (``data/wire.py``) is
decoded on the device after its padding, before the forward.

Under a multi-device layout (``parallel/mesh.py``: DDP, FSDP2 or HSDP)
each rank runs its rows of every microbatch. The losses are the global
batch's (``train/losses.py``), and each rank's backward is scaled by the
rank count, so the wrapper's mean of the ranks' gradients is the global
gradient. The gradients are reduced once per optimizer step, in fp32, in
the last microbatch's backward; the earlier ones add up locally. The
metrics and ``grad_norm`` come out the same, bit for bit, on every rank.
Padding (``train.pad_microbatch_to``) pads each rank's rows to that size,
so the global microbatch has ranks times as many rows. The padded rows
carry no weight in any global normalizer; the dropout masks are drawn for
the padded global batch, so a real row's mask sits at another position
of the draw than in a one-process step.

Under the sp layout every rank holds the whole microbatch (padded alike on
every rank) and runs the forward and backward on its rows of every image
(``parallel/spatial.py``): the GT pyramid is built from the whole depth
map, whose 3x3 windows reach one row past a rank's cut, and then every
map is cut to the rank's rows. The losses' masked sums and counts add up
over the sp group; the dropout masks are the whole batch's, as in one
process. Each rank's backward gives its terms of the global gradient
(``parallel/mesh.py``'s convention), and their sum over the ranks is taken
once per optimizer step, in fp32, after the last microbatch's backward.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from camradepth_tpu_torch.data.wire import decode_wire_micro, is_wire_micro
from camradepth_tpu_torch.ops.pooling import minpool_sparse
from camradepth_tpu_torch.parallel import spatial
from camradepth_tpu_torch.parallel.mesh import (
    batch_shard,
    row_shard,
    set_gradient_sync,
    sum_over_ranks,
    unwrap,
)
from camradepth_tpu_torch.parallel.multihost import is_dtensor
from camradepth_tpu_torch.train.losses import multitask_loss


def pad_microbatch(micro: Dict[str, torch.Tensor],
                   target: int) -> Dict[str, torch.Tensor]:
    """Pad a microbatch with dummy samples up to ``target`` rows
    (``camradepth_tpu/train/step.py:34-59``): depth GT zeros and seg labels
    255, which every masked loss term ignores, so the loss and the
    gradients equal the unpadded step's."""
    def pad(name, a):
        mb = a.shape[0]
        if a.ndim == 0 or mb >= target:
            return a
        fill = 255 if name.startswith("seg") else 0
        extra = a.new_full((target - mb,) + tuple(a.shape[1:]), fill)
        return torch.cat([a, extra], dim=0)

    return {k: (v if v is None else pad(k, v)) for k, v in micro.items()}


def build_gt(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Deep-supervision targets from the raw batch (pyramid on the
    device)."""
    gt_depth = batch["gt_depth"]
    s3 = minpool_sparse(gt_depth)  # H/2
    s2 = minpool_sparse(s3)  # H/4
    return {
        "depth": gt_depth,
        "depth_stage4": s3,
        "depth_stage3": s2,
        "seg": batch.get("seg"),
        "seg_inter": batch.get("seg_inter"),
    }


def prepare_microbatch(cfg, micro: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """A microbatch padded to ``train.pad_microbatch_to`` and, if it came
    as a compact wire batch, decoded on its device."""
    if cfg.train.pad_microbatch_to:
        micro = pad_microbatch(micro, cfg.train.pad_microbatch_to)
    if is_wire_micro(micro):
        micro = decode_wire_micro(micro)
    return micro


def gt_rows(gt: Dict[str, Optional[torch.Tensor]], shard
            ) -> Dict[str, Optional[torch.Tensor]]:
    """This rank's rows of every map of a :func:`build_gt` dict built from
    the whole image (all of it for no ``shard``)."""
    if shard is None:
        return gt
    return {k: None if v is None else shard.local(v) for k, v in gt.items()}


def model_inputs(model, micro: Dict[str, torch.Tensor]):
    """(the features ``model`` runs on, the GT targets, the losses' shard)
    of a prepared microbatch: under sp this rank's rows of both and the
    sp group; else the whole of both and the batch shard (or None)."""
    shard = row_shard(model)
    x = micro["features"]
    gt = build_gt(micro)
    if shard is None:
        return x, gt, batch_shard(model)
    return shard.local(x), gt_rows(gt, shard), shard


def microbatch_loss(cfg, model, micro: Dict[str, torch.Tensor],
                    generator: Optional[torch.Generator] = None):
    """(loss, metrics) of one microbatch in train mode, its dropout drawn
    from ``generator``; the global batch's under a layout."""
    micro = prepare_microbatch(cfg, micro)
    unwrap(model).set_generator(generator)
    x, gt, shard = model_inputs(model, micro)
    with spatial.sharded(row_shard(model)):
        pred = model(x)
    return multitask_loss(pred, gt, cfg, shard)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm). Of
    FSDP2's sharded gradients (DTensors, all on one mesh) each rank sums
    its shards' squares and the sums are all-reduced over the sharded mesh
    dimensions."""
    sharded = [t for t in tensors if is_dtensor(t)]
    if not sharded:
        return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                              for t in tensors))

    mesh, placements = sharded[0].device_mesh, sharded[0].placements
    if any(t.device_mesh != mesh or t.placements != placements
           for t in sharded):
        raise ValueError("global_norm takes DTensors of one mesh and "
                         "placement")
    sq = sum(torch.sum(torch.square(t.to_local().float())) for t in sharded)
    for dim, placement in enumerate(placements):
        if placement.is_shard():
            dist.all_reduce(sq, group=mesh.get_group(dim))
    return torch.sqrt(sum((torch.sum(torch.square(t.float()))
                           for t in tensors if not is_dtensor(t)), sq))


def train_step(cfg, model, optimizer, microbatches: List[Dict],
               generators: Sequence[Optional[torch.Generator]],
               lr: float, loss_fn: Callable = microbatch_loss
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step over ``microbatches`` (``update_interval`` dicts
    of device tensors), microbatch i's dropout drawn from
    ``generators[i]``, at learning rate ``lr``. ``loss_fn(cfg, model,
    micro, generator) -> (loss, metrics)`` is the objective of one
    microbatch (the distillation step passes its own). Returns the
    metrics, each the mean over the microbatches, and ``grad_norm``, the
    global L2 norm of the averaged gradients (0-d device tensors: reading
    one waits for the step). ``model`` may be wrapped for a layout (see the
    module docstring)."""
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer.zero_grad(set_to_none=True)
    shard = batch_shard(model)
    per_micro = []
    for i, (micro, gen) in enumerate(zip(microbatches, generators)):
        if shard is not None:
            set_gradient_sync(model, i == len(microbatches) - 1)
        loss, metrics = loss_fn(cfg, model, micro, gen)
        (loss if shard is None else loss * shard.count).backward()
        per_micro.append({k: v.detach() for k, v in metrics.items()})
    accum = len(per_micro)
    with torch.no_grad():
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if row_shard(model) is not None:
            sum_over_ranks([p.grad for p in params])
        if accum > 1:
            for p in params:
                p.grad.div_(accum)
        grad_norm = global_norm([p.grad for p in params])
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    out = {k: torch.stack([m[k] for m in per_micro]).mean()
           for k in per_micro[0]}
    out["grad_norm"] = grad_norm
    return out


@torch.no_grad()
def eval_step(cfg, model, batch: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """Per-frame metrics of a batch in eval mode, each [B]
    (``camradepth_tpu/train/step.py:152-179``): the loss terms of each
    frame alone, so the caller can drop the loader's padded tail frames
    and weight the aggregate by frame. Under sp each rank scores its rows
    with the sp group's sums: every rank gets the whole frames' metrics,
    bit for bit the same."""
    if is_wire_micro(batch):
        batch = decode_wire_micro(batch)
    x, gt, _ = model_inputs(model, batch)
    with spatial.sharded(row_shard(model)):
        pred = model(x)
    n = x.shape[0]

    def frame(tree, i):
        if isinstance(tree, dict):
            return {k: frame(v, i) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(frame(v, i) for v in tree)
        return None if tree is None else tree[i:i + 1]

    rows = [multitask_loss(frame(pred, i), frame(gt, i), cfg,
                           row_shard(model))[1] for i in range(n)]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
