"""The training and serving layouts: their sizes, the device mesh and the
model's wrapper.

Counterpart of ``camradepth_tpu/parallel/mesh.py``, of the trainer's
``_auto_mesh`` (``camradepth_tpu/train/trainer.py:100-163``) and of
``serving_mesh`` (``camradepth_tpu/serving.py:382-410``). Each rank holds
one device. Serving (:class:`ServingMesh`) shards a batch's rows over
``data`` and the image's rows over ``sp`` (``parallel/spatial.py``).

In training the global microbatch (``train.batch_size`` rows) shards
jointly over ``data`` x ``fsdp`` ranks, as the JAX package's batch does
(``camradepth_tpu/parallel/mesh.py:95-100``), or each image's rows over
``sp`` ranks, so the layout covers every rank:

- ``data`` only: DDP, a full replica on each rank, the gradients
  all-reduced once per optimizer step;
- ``fsdp``: FSDP2 (``fully_shard``) on a 1-D mesh, every encoder block,
  every decoder stage and then the root each a unit whose parameters,
  gradients and optimizer state are sharded over the ranks;
- ``data`` x ``fsdp``: FSDP2 on the 2-D mesh ``("data", "fsdp")`` (HSDP),
  replicated over ``data`` and sharded over ``fsdp``;
- ``sp`` (2, alone: the one case the JAX package trains, its GSPMD conv
  gradients being wrong otherwise): every rank holds the whole microbatch,
  the parameters and the optimizer state, and runs the forward and
  backward on its rows of every feature map (``parallel/spatial.py``; the
  model unwrapped, its :attr:`row_shard` set). Its spatial collectives run
  on a process group of their own, so the gradient sum, on the default
  group, never interleaves with a halo exchange.

One convention for the gradients: each rank's backward gives its terms of
the global gradient, and the gradient of the step is their sum over the
ranks, in fp32, once per optimizer step, after the last microbatch's
backward. DDP and FSDP2 take the mean over the ranks, so their ranks scale
the loss by the rank count (``train/step.py``); under sp the ranks' terms
are summed as they are (:func:`sum_over_ranks`).

JAX's ``param_sharding_rule`` picks the axis to shard per parameter to suit
GSPMD, and keeps parameters under 2**16 elements and depthwise kernels
whole. FSDP2 shards dim 0 of every parameter of a unit, padding the last
shard: no parameter stays whole, and none needs to, since the sharded axis
changes where the numbers live, not what they are. Gradients reduce in
fp32 (no ``MixedPrecisionPolicy``); the bf16 compute dtype is a cast at use
(``models/layers.py`` ``cast_to``), as on one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from camradepth_tpu_torch.config import ConfigError
from camradepth_tpu_torch.parallel import multihost


@dataclass(frozen=True)
class Layout:
    """``data`` x ``fsdp`` ranks, or ``sp`` ranks alone. ``wrap`` names
    the wrapper ("ddp" or "fsdp"); empty, it follows from the sizes (sp
    when ``sp`` > 1, FSDP2 when ``fsdp`` > 1, else DDP). An explicit
    wrapper is how a one-rank DDP or FSDP2 run is driven
    (``Trainer(layout=...)``)."""

    data: int = 1
    fsdp: int = 1
    wrap: str = ""
    sp: int = 1

    def __post_init__(self):
        if self.wrap not in ("", "ddp", "fsdp"):
            raise ConfigError(f"layout wrap must be ddp or fsdp, got "
                              f"{self.wrap!r}")
        if self.wrap == "ddp" and self.fsdp != 1:
            raise ConfigError("a DDP layout has no fsdp axis")
        if self.sp > 1 and (self.data * self.fsdp > 1 or self.wrap):
            raise ConfigError("an sp layout has no data or fsdp axis and "
                              "no wrapper")

    @property
    def size(self) -> int:
        return self.data * self.fsdp * self.sp

    @property
    def kind(self) -> str:
        if self.sp > 1:
            return "sp"
        return self.wrap or ("fsdp" if self.fsdp > 1 else "ddp")


def mesh_shape(data_parallel: int, fsdp_parallel: int, spatial_parallel: int,
               world: int, batch_size: int, img_height: int
               ) -> Optional[Tuple[int, int, int]]:
    """The (data, fsdp, sp) sizes ``_auto_mesh`` gives for ``world``
    devices, or None for one device; the same refusals
    (``camradepth_tpu/train/trainer.py:100-163``). With ``data_parallel``
    -1 the data axis is the largest divisor of the global batch that fits
    the ranks left by fsdp (the batch shards jointly over data x fsdp);
    explicit sizes are strict."""
    fsdp = max(1, fsdp_parallel)
    sp = max(1, spatial_parallel)
    if data_parallel > 0:
        data = data_parallel
    elif sp > 1:
        data = 1
    else:
        avail = max(1, world // (fsdp * sp))
        data = 1
        for d in range(min(avail, batch_size), 0, -1):
            if batch_size % (d * fsdp) == 0:
                data = d
                break
    if data * fsdp * sp == 1:
        return None
    if sp > 1 and data * fsdp > 1:
        raise ConfigError(
            "spatial_parallel cannot be combined with data/fsdp axes in "
            "training: the JAX package's GSPMD miscomputes conv gradients "
            "when spatially-sharded activations are partially replicated "
            "across other mesh axes")
    if sp > 2:
        raise ConfigError(
            "spatial_parallel > 2 in training produces wrong conv gradients "
            "in the JAX package (gradcheck-verified safe: sp=2 sole axis)")
    if batch_size % (data * fsdp):
        raise ConfigError(
            f"batch_size {batch_size} is not divisible by data_parallel*"
            f"fsdp={data}x{fsdp} (batches shard jointly over both axes)")
    if data * fsdp * sp > world:
        raise ConfigError(
            f"layout {data}x{fsdp}x{sp} needs {data * fsdp * sp} ranks, have "
            f"{world}: start one process per rank (torchrun --nproc-per-node "
            "N, or --coordinator/--num-processes/--process-id)")
    if sp > 1 and img_height % sp:
        raise ConfigError(f"image height {img_height} is not divisible by "
                          f"spatial_parallel={sp}")
    return data, fsdp, sp


def training_layout(cfg, world: Optional[int] = None) -> Optional[Layout]:
    """The layout of ``cfg.mesh`` over ``world`` ranks (default: the
    process group's size), or None for one unwrapped device. A process
    group of more than one rank needs a layout that covers every rank:
    each rank holds its share of the batch, or of every image's rows. The
    refusals are ``mesh_shape``'s, then the port's own limit on sp
    (``spatial.partition``: rows at /32, at least one a rank)."""
    from camradepth_tpu_torch.parallel.spatial import partition

    world = multihost.process_count() if world is None else world
    m = cfg.mesh
    shape = mesh_shape(m.data_parallel, m.fsdp_parallel, m.spatial_parallel,
                       world, cfg.train.batch_size, cfg.model.img_size[0])
    if shape is None:
        if world > 1:
            raise ConfigError(
                f"{world} processes need a training layout over all of "
                f"them: batch_size {cfg.train.batch_size} with --fsdp "
                f"{m.fsdp_parallel} gives one rank; size --data-parallel / "
                "--fsdp (and the batch) to the ranks")
        return None
    data, fsdp, sp = shape
    if sp > 1:
        partition(cfg.model.img_size[0], sp)
    if data * fsdp * sp != world:
        raise ConfigError(
            f"layout {data}x{fsdp}x{sp} covers {data * fsdp * sp} of {world} "
            "ranks; a rank without a share of the batch would stall the "
            "others: size --data-parallel / --fsdp (and the batch) to the "
            "ranks")
    return Layout(sp=sp) if sp > 1 else Layout(data, fsdp)


def create_mesh(layout: Layout, device_type: str):
    """The ``("data", "fsdp")`` device mesh of ``layout`` over the process
    group's ranks, row-major."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (layout.data, layout.fsdp),
                            mesh_dim_names=("data", "fsdp"))


def unwrap(model):
    """The CamRaDepth inside a DDP wrapper (FSDP2 wraps in place)."""
    from torch.nn.parallel import DistributedDataParallel

    return model.module if isinstance(model, DistributedDataParallel) \
        else model


def fsdp_units(model):
    """The modules FSDP2 shards as units of their own, in the order they
    run: each encoder block, each decoder stage (the seg branch's too)."""
    enc = model.dest_encoder
    units = [blk for i in range(4) for blk in getattr(enc, f"block{i + 1}")]
    units += list(model.depth_upsample)
    if hasattr(model, "seg_upsample"):
        units += list(model.seg_upsample)
    return units


def wrap(model, layout: Layout):
    """``model`` (a CamRaDepth on this rank's device, the same weights on
    every rank) under ``layout``'s wrapper, its dropout drawn for this
    rank's rows of the global batch; under sp the model itself, set to run
    on this rank's rows of every image (its dropout drawn for the whole
    batch, which every rank holds). Needs a process group of
    ``layout.size`` ranks."""
    import torch.distributed as dist
    from torch.distributed.fsdp import fully_shard
    from torch.nn.parallel import DistributedDataParallel

    from camradepth_tpu_torch.parallel.spatial import RowShard, partition

    world = multihost.process_count()
    if layout.size != world:
        raise ConfigError(f"layout {layout.data}x{layout.fsdp}x{layout.sp} "
                          f"needs {layout.size} ranks, the process group "
                          f"has {world}")
    if layout.kind == "sp":
        # the spatial collectives' own group (module docstring)
        group = dist.new_group(list(range(world)))
        model.row_shard = RowShard(partition(model.cfg.img_size[0],
                                             layout.sp),
                                   multihost.process_index(), group)
        return model
    dev = next(model.parameters()).device
    model.set_batch_shard(multihost.BatchShard(multihost.process_index(),
                                               world))
    if layout.kind == "ddp":
        # the unsupervised seg heads feed the loss only through an argmax:
        # no gradient reaches them
        return DistributedDataParallel(
            model, device_ids=[dev.index] if dev.type == "cuda" else None,
            broadcast_buffers=False,
            find_unused_parameters=model.cfg.unsupervised_seg)
    # FSDP2 shards contiguous parameters only: the conv weights leave
    # channels_last, and cuDNN lays each one out for an NHWC input at use
    for p in model.parameters():
        p.data = p.data.contiguous()
    mesh = create_mesh(layout, dev.type)
    mesh = mesh if layout.data > 1 else mesh["fsdp"]
    for unit in fsdp_units(model):
        fully_shard(unit, mesh=mesh)
    fully_shard(model, mesh=mesh)
    return model


def set_gradient_sync(model, enabled: bool) -> None:
    """Reduce the gradients in this backward (``enabled``) or keep adding
    them up locally: DDP's ``require_backward_grad_sync``, FSDP2's
    ``set_requires_gradient_sync``. Nothing for an unwrapped model."""
    from torch.distributed.fsdp import FSDPModule
    from torch.nn.parallel import DistributedDataParallel

    if isinstance(model, DistributedDataParallel):
        model.require_backward_grad_sync = enabled
    elif isinstance(model, FSDPModule):
        model.set_requires_gradient_sync(enabled)


def batch_shard(model) -> Optional[multihost.BatchShard]:
    """The rows of the global batch that ``model`` (wrapped or not) runs
    on this rank; None for one unwrapped device and under sp."""
    return unwrap(model).batch_shard


def row_shard(model):
    """The rows of every image that ``model`` runs on this rank under sp
    (a ``spatial.RowShard``); None else."""
    return unwrap(model).row_shard


def sum_over_ranks(tensors) -> None:
    """Replace each of ``tensors`` (fp32, on one device, the same shapes on
    every rank) by its sum over the process group's ranks, in rank order,
    so every rank gets the same bits: one all-gather of them all,
    flattened."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    x = flat.to(multihost.collective_device())
    parts = [torch.empty_like(x) for _ in range(multihost.process_count())]
    dist.all_gather(parts, x)
    total = parts[0].to(flat.device)
    for p in parts[1:]:
        total += p.to(flat.device)
    at = 0
    for t in tensors:
        t.copy_(total[at:at + t.numel()].view_as(t))
        at += t.numel()


@dataclass(frozen=True)
class ServingLayout:
    """``data`` x ``sp`` ranks of a serving mesh, rank = d * sp + s (the
    JAX package's ``(data, sp)`` mesh, row-major): each ``data`` group of
    ranks serves its rows of a batch, each ``sp`` rank its rows of the
    image."""

    data: int = 1
    sp: int = 1

    @property
    def size(self) -> int:
        return self.data * self.sp


def serving_layout(data_parallel: int, spatial_parallel: int,
                   img_height: int, batch_size: int, artifact: bool = False,
                   wire_format: str = "off") -> Optional[ServingLayout]:
    """The serving layout of ``data_parallel`` x ``spatial_parallel``
    ranks, or None for one process: every refusal of a serving layout, made
    before any process starts. They are the JAX package's
    (``camradepth_tpu/cli.py:679-723``, ``serving_mesh``): a batch that the
    ``data`` groups do not share evenly, an image height that sp does not
    divide, an artifact on a mesh and ``wire_format=on`` with sp; and the
    port's own limit on sp (``spatial.partition``). :func:`serving_mesh`
    then checks the layout against the process group."""
    from camradepth_tpu_torch.parallel.spatial import partition

    data, sp = max(1, data_parallel), max(1, spatial_parallel)
    if data > 1 and batch_size % data:
        raise ConfigError(f"--serve-batch {batch_size} is not divisible by "
                          f"--data-parallel {data}")
    if sp > 1:
        if img_height % sp:
            raise ConfigError(f"image height {img_height} is not divisible "
                              f"by --spatial-parallel {sp}")
        partition(img_height, sp)
    if artifact and data * sp > 1:
        raise ConfigError(
            "serving artifacts cannot be served with --data-parallel/"
            "--spatial-parallel: their partitioning is fixed at export "
            "time; serve the .pth checkpoint instead")
    if sp > 1 and wire_format == "on":
        raise ConfigError(
            "data.wire_format=on is incompatible with artifact / spatially-"
            "sharded serving: use wire auto or off")
    return None if data * sp == 1 else ServingLayout(data, sp)


def serving_mesh(layout: Optional[ServingLayout],
                 img_height: int) -> Optional[ServingMesh]:
    """This rank's :class:`ServingMesh` of ``layout`` (None: one process),
    which must cover every rank of the process group."""
    world = multihost.process_count()
    if layout is None:
        if world > 1:
            raise ConfigError(
                f"{world} processes need a serving layout over all of them: "
                "size --data-parallel x --spatial-parallel to the ranks")
        return None
    if layout.size != world:
        raise ConfigError(
            f"serving layout {layout.data}x{layout.sp} needs {layout.size} "
            f"ranks, have {world}: start one process per rank (torchrun "
            "--nproc-per-node N, or --coordinator/--num-processes/"
            "--process-id)")
    return ServingMesh(layout, img_height)


class ServingMesh:
    """This rank's place in a serving layout: its share of a batch, its
    rows of the image (``rows``, a ``spatial.RowShard``; None when sp is 1)
    and the gather of the maps to rank 0. Every rank of the process group
    builds it (the sub-groups are collective)."""

    def __init__(self, layout: ServingLayout, img_height: int):
        from camradepth_tpu_torch.parallel.spatial import RowShard, partition

        self.layout = layout
        self.data_index, self.sp_index = divmod(multihost.process_index(),
                                                layout.sp)
        sp_group, _ = multihost.grid_groups(layout.data, layout.sp)
        self.rows = None
        if layout.sp > 1:
            self.rows = RowShard(partition(img_height, layout.sp),
                                 self.sp_index, sp_group)

    def batch_rows(self, batch_size: int) -> slice:
        """This rank's rows of a batch of ``batch_size``."""
        per = batch_size // self.layout.data
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def gather(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """The whole [B, H, ...] batch on rank 0 (on the host) from every
        rank's [B / data, h, ...] piece; None on the other ranks."""
        import torch.distributed as dist

        from camradepth_tpu_torch.parallel.spatial import join_rows, pad_rows

        sizes = ([t.shape[1]] if self.rows is None
                 else self.rows.level_sizes(t.shape[1]))
        piece = pad_rows(t.contiguous().to(multihost.collective_device()),
                         max(sizes))
        primary = multihost.is_primary()
        parts = ([torch.empty_like(piece) for _ in range(self.layout.size)]
                 if primary else None)
        dist.gather(piece, parts, dst=0)
        if not primary:
            return None
        sp = self.layout.sp
        return torch.cat([join_rows(parts[d * sp:(d + 1) * sp], sizes)
                          for d in range(self.layout.data)], dim=0).cpu()
