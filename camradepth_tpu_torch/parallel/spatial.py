"""Spatial parallel serving and training: the image's rows sharded over an
``sp`` group of ranks, each rank holding its rows of every feature map.

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

Every collective is differentiable (spatially sharded training, where the
JAX package differentiates through GSPMD's). The gradients follow the
"local terms" convention of ``multihost._SumAcrossRanks``: a rank's
backward gives the terms of the global gradient that its own rows
produced, and the parameter gradients of the ranks add up to the global
one. A tensor that every rank holds whole and feeds to its own rows (the
gathered keys, a global sum) thus gets on each rank only that rank's share
of its gradient, so the backward of the collective that made it sums the
shares: :func:`halo` hands each attached row's gradient back to the rank
that owns the row, :func:`all_gather_rows` gives each rank the sum over the
ranks of its rows' gradients (a reduce-scatter), and :func:`sum_across`
gives each rank's partial sum the sum of the ranks' gradients (an
all-reduce). Every sum runs in rank order, in fp32. Each backward uses
the shard saved at its forward, never :func:`active`: on the card the
autograd engine runs the backward on a thread of its own, where the
forward's context is not set. :meth:`RowShard.sum_grad` is the other
kind of sum: a loss's numerator, which every rank then uses whole and
seeds once, so its gradient passes to each rank's term as it is.
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

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole [B, H, ...] tensor, contiguous."""
        return t[:, self.rows(t.shape[1])].contiguous()

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
        return _rank_order_sum(self.all_gather(t))

    # the losses' shard under sp (train/losses.py takes it where it takes
    # a parallel/multihost.BatchShard)
    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, outside autograd."""
        return self.all_reduce(t.detach())

    def sum_grad(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, the gradient passed to each rank's
        ``t`` as it is: a loss's numerator, which every rank uses whole
        and seeds once (module docstring)."""
        return _SumTerms.apply(t, self)


def _rank_order_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class _SumTerms(torch.autograd.Function):
    """:meth:`RowShard.sum_grad`: the sum over the ranks, whose gradient
    reaches each rank's term unchanged."""

    @staticmethod
    def forward(ctx, t, shard):
        return shard.all_reduce(t)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumAcross(torch.autograd.Function):
    """:func:`sum_across`: every rank uses the global sum on its own rows,
    so the gradient of a rank's partial sum is the sum of the ranks'
    gradients of the global one."""

    @staticmethod
    def forward(ctx, t, shard):
        ctx.shard = shard
        return shard.all_reduce(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.all_reduce(grad.contiguous()), None


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


def _offsets(sizes: List[int]) -> List[int]:
    out = [0]
    for n in sizes[:-1]:
        out.append(out[-1] + n)
    return out


def _attached(sizes: List[int], r: int, top: int, bottom: int
              ) -> Tuple[int, int]:
    """How many rows rank ``r`` attaches above and below its own: up to
    ``top`` and ``bottom``, fewer at the image's edges."""
    start = sum(sizes[:r])
    return min(top, start), min(bottom, sum(sizes) - start - sizes[r])


class _Halo(torch.autograd.Function):
    """:func:`halo`. The forward attaches the neighbours' rows; the
    backward gathers every rank's gradients of the rows it attached (the
    mirror of the forward's exchange) and adds those of this rank's own
    rows to their gradient, in rank order, in fp32."""

    @staticmethod
    def forward(ctx, x, shard, top, bottom):
        k = max(top, bottom)
        h = x.shape[1]
        sizes = shard.level_sizes(h)
        edges = torch.cat([pad_rows(x[:, :k], k),
                           pad_rows(x[:, max(0, h - k):], k)], dim=1)
        pieces = shard.all_gather(edges)
        i = shard.index
        n_top, n_bottom = _attached(sizes, i, top, bottom)
        above, need = [], n_top
        for j in range(i - 1, -1, -1):
            if need == 0:
                break
            n = min(k, sizes[j])
            take = min(n, need)
            above.insert(0, pieces[j][:, k + n - take:k + n])
            need -= take
        below, need = [], n_bottom
        for j in range(i + 1, shard.size):
            if need == 0:
                break
            take = min(k, sizes[j], need)
            below.append(pieces[j][:, :take])
            need -= take
        ctx.plan = (shard, sizes, top, bottom, n_top, h)
        return torch.cat(above + [x] + below, dim=1)

    @staticmethod
    def backward(ctx, grad):
        shard, sizes, top, bottom, n_top, h = ctx.plan
        k = max(top, bottom)
        edges = torch.cat([pad_rows(grad[:, :n_top], k),
                           pad_rows(grad[:, n_top + h:], k)], dim=1)
        pieces = shard.all_gather(edges)
        i = shard.index
        offs = _offsets(sizes)
        mine = offs[i]
        out = grad[:, n_top:n_top + h].to(torch.float32, copy=True)
        for r in range(shard.size):
            if r == i:
                continue
            nt, nb = _attached(sizes, r, top, bottom)
            # rank r's attached rows: above from global row offs[r] - nt,
            # below from offs[r] + sizes[r] (at row k of its piece)
            for first, count, at in ((offs[r] - nt, nt, 0),
                                     (offs[r] + sizes[r], nb, k)):
                lo, hi = max(first, mine), min(first + count, mine + h)
                if lo < hi:
                    out[:, lo - mine:hi - mine] += pieces[r][
                        :, at + lo - first:at + hi - first].float()
        return out.to(grad.dtype), None, None, None


def halo(x: torch.Tensor, top: int, bottom: int
         ) -> Tuple[torch.Tensor, int, int]:
    """This rank's rows of ``x`` [B, h, ...] with up to ``top`` rows of the
    ranks above and ``bottom`` of the ranks below attached, and how many
    were attached on each side. At the image's own edges it attaches
    nothing, so fewer come back there; a neighbour that owns fewer rows
    than asked passes on its own neighbour's. Every rank of the group
    calls it (one all-gather of each rank's first and last rows, and one
    of the attached rows' gradients in the backward)."""
    shard = active()
    if shard is None or (top == 0 and bottom == 0):
        return x, 0, 0
    n_top, n_bottom = _attached(shard.level_sizes(x.shape[1]), shard.index,
                                top, bottom)
    return _Halo.apply(x, shard, top, bottom), n_top, n_bottom


class _GatherRows(torch.autograd.Function):
    """:func:`all_gather_rows`. Every rank uses the whole map on its own
    rows, so the gradient of a rank's rows is the sum over the ranks of
    their gradients of those rows: an all-gather of the whole gradient and
    a sum in rank order, in fp32 (a reduce-scatter whose bits do not
    depend on the backend)."""

    @staticmethod
    def forward(ctx, x, shard):
        sizes = shard.level_sizes(x.shape[1])
        ctx.plan = (shard, sizes)
        return join_rows(shard.all_gather(pad_rows(x, max(sizes))), sizes)

    @staticmethod
    def backward(ctx, grad):
        shard, sizes = ctx.plan
        start = sum(sizes[:shard.index])
        parts = shard.all_gather(grad)
        own = [p[:, start:start + sizes[shard.index]].float() for p in parts]
        return _rank_order_sum(own).to(grad.dtype), None


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole feature map [B, H, ...] from every rank's rows [B, h, ...]
    (on every rank); ``x`` itself on one process."""
    shard = active()
    return x if shard is None else _GatherRows.apply(x, shard)


def sum_across(t: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of the ranks' partial sums ``t``; ``t`` in fp32 on one
    process."""
    shard = active()
    t = t.float()
    return t if shard is None else _SumAcross.apply(t, shard)
