"""Spatial parallel inference: the image's rows sharded over an ``sp`` group
of ranks, each rank holding its rows of every feature map.

The counterpart of what GSPMD does for the ``sp`` axis of the JAX package's
serving mesh (``camradepth_tpu/serving.py:99-177``, ``serving_mesh``
``:382-410``): halo rows for every window taller than one row, the
cross-shard sums of GroupNorm and of the attention's token mean, and the
keys gathered whole.

Rows are partitioned at the encoder's coarsest level, /32: 13 rows at
416x800, split as evenly as possible, the first ranks taking one more
(7 and 6 for sp = 2). A rank's rows at a finer level are its /32 rows times
the level's factor (x2 per level, x32 at the input). Anchored there, each
stage's sr-conv window covers whole /32 rows, every decoder upsample lands
on the rows of its skip, and ``space_to_depth`` stays local to a rank. A
rank must own at least one /32 row, so sp is at most the image's /32 row
count (13 at 416x800); the JAX package takes any sp that divides H, as
GSPMD pads.

The model's layers consult the ambient shard (:func:`active`), as the JAX
layers read the ambient ``with mesh:``: :func:`sharded` sets it around a
forward. Without it every helper is the identity, so the single-process
path runs the same operations as before.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from camradepth_tpu_torch.config import ConfigError

# the encoder's coarsest stride: the rows of the partition
ROW_UNIT = 32


def partition(img_height: int, sp: int) -> Tuple[int, ...]:
    """The /32 rows of each of ``sp`` ranks for an image ``img_height`` rows
    tall: as even as possible, the first ranks one more."""
    if img_height % ROW_UNIT:
        raise ConfigError(f"spatial parallel needs an image height that is "
                          f"a multiple of {ROW_UNIT}, got {img_height}")
    rows = img_height // ROW_UNIT
    if sp > rows:
        raise ConfigError(
            f"spatial_parallel {sp} exceeds the {rows} rows of the image at "
            f"/{ROW_UNIT} ({img_height} // {ROW_UNIT}): each rank must own "
            "at least one row of the encoder's coarsest stage, so sp is at "
            f"most {rows} here")
    q, r = divmod(rows, sp)
    return tuple(q + (i < r) for i in range(sp))


@dataclass(frozen=True)
class RowShard:
    """Rank ``index`` of an sp group whose ranks own ``counts`` rows at /32,
    in order from the image's top; ``group`` is the group's
    ``torch.distributed`` process group."""

    counts: Tuple[int, ...]
    index: int
    group: Any = None

    @property
    def size(self) -> int:
        return len(self.counts)

    def factor(self, local_rows: int) -> int:
        """The level of a feature map whose local height is ``local_rows``:
        its rows per /32 row."""
        f, r = divmod(local_rows, self.counts[self.index])
        if r or f < 1:
            raise ValueError(
                f"{local_rows} rows are no level of rank {self.index}'s "
                f"{self.counts[self.index]} rows at /{ROW_UNIT}")
        return f

    def level_sizes(self, local_rows: int) -> List[int]:
        """Every rank's rows at the level of a feature map whose local
        height is ``local_rows``, in rank order."""
        f = self.factor(local_rows)
        return [c * f for c in self.counts]

    def rows(self, height: int) -> slice:
        """This rank's rows of a whole feature map ``height`` rows tall."""
        f, r = divmod(height, sum(self.counts))
        if r or f < 1:
            raise ValueError(f"a height of {height} rows is no level of a "
                             f"{sum(self.counts)}-row partition")
        start = sum(self.counts[:self.index]) * f
        return slice(start, start + self.counts[self.index] * f)

    def global_count(self, local_count: int) -> int:
        """The whole image's count of what this rank has ``local_count``
        of, in proportion to the rows (elements of a feature map, its
        tokens)."""
        q, r = divmod(local_count, self.counts[self.index])
        if r:
            raise ValueError(f"{local_count} does not scale with rank "
                             f"{self.index}'s {self.counts[self.index]} rows")
        return q * sum(self.counts)

    # the one collective every helper goes through
    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (the same shape on all), in rank order, on
        ``t``'s device; staged through the host under gloo."""
        from camradepth_tpu_torch.parallel.multihost import collective_device

        x = t.contiguous().to(collective_device())
        outs = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(outs, x, group=self.group)
        return [o.to(t.device) for o in outs]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group's ranks, in rank order: an all-gather
        and a local sum, so every rank and every run gets the same bits
        whatever order the backend would reduce in (with NCCL's all-reduce
        over four H100s, two forwards of one frame came out differently)."""
        parts = self.all_gather(t)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out


_ACTIVE: ContextVar[Optional[RowShard]] = ContextVar("camradepth_spatial",
                                                     default=None)


def active() -> Optional[RowShard]:
    """The shard the current forward runs on; None on one process."""
    return _ACTIVE.get()


@contextlib.contextmanager
def sharded(shard: Optional[RowShard]):
    """Run the enclosed forward on ``shard``'s rows; None marks a region
    whose tensors are whole on every rank (the gathered keys), where the
    helpers are the identity. The shard is per thread, so a server's
    worker thread sets its own."""
    token = _ACTIVE.set(shard)
    try:
        yield shard
    finally:
        _ACTIVE.reset(token)


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` [B, h, ...] with zero rows appended up to ``rows``: the equal
    shapes a collective takes from ranks that own unequal rows."""
    if x.shape[1] == rows:
        return x
    pad = x.new_zeros((x.shape[0], rows - x.shape[1]) + tuple(x.shape[2:]))
    return torch.cat([x, pad], dim=1)


def join_rows(pieces: List[torch.Tensor], sizes: List[int]) -> torch.Tensor:
    """The rows of each rank's padded piece (:func:`pad_rows`), ``sizes``
    of them, joined in rank order."""
    return torch.cat([p[:, :s] for p, s in zip(pieces, sizes)], dim=1)


def halo(x: torch.Tensor, top: int, bottom: int
         ) -> Tuple[torch.Tensor, int, int]:
    """This rank's rows of ``x`` [B, h, ...] with up to ``top`` rows of the
    ranks above and ``bottom`` of the ranks below attached, and how many
    were attached on each side. At the image's own edges it attaches
    nothing, so fewer come back there; a neighbour that owns fewer rows
    than asked passes on its own neighbour's. Every rank of the group
    calls it (one all-gather of each rank's first and last rows)."""
    shard = active()
    if shard is None or (top == 0 and bottom == 0):
        return x, 0, 0
    k = max(top, bottom)
    h = x.shape[1]
    sizes = shard.level_sizes(h)
    edges = torch.cat([pad_rows(x[:, :k], k),
                       pad_rows(x[:, max(0, h - k):], k)], dim=1)
    pieces = shard.all_gather(edges)
    i = shard.index
    above, need = [], top
    for j in range(i - 1, -1, -1):
        if need == 0:
            break
        n = min(k, sizes[j])
        take = min(n, need)
        above.insert(0, pieces[j][:, k + n - take:k + n])
        need -= take
    n_top = top - need
    below, need = [], bottom
    for j in range(i + 1, shard.size):
        if need == 0:
            break
        take = min(k, sizes[j], need)
        below.append(pieces[j][:, :take])
        need -= take
    n_bottom = bottom - need
    return torch.cat(above + [x] + below, dim=1), n_top, n_bottom


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole feature map [B, H, ...] from every rank's rows [B, h, ...]
    (on every rank); ``x`` itself on one process."""
    shard = active()
    if shard is None:
        return x
    sizes = shard.level_sizes(x.shape[1])
    return join_rows(shard.all_gather(pad_rows(x, max(sizes))), sizes)


def sum_across(t: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of the ranks' partial sums ``t``; ``t`` in fp32 on one
    process."""
    shard = active()
    t = t.float()
    return t if shard is None else shard.all_reduce(t)
