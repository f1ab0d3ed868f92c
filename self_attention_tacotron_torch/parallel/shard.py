"""A data-parallel step's view of the global batch.

Under GSPMD the JAX package's sharded step computes the global batch's loss
exactly: every loss normaliser and every batch-norm statistic is taken over the
whole batch, and every random mask is drawn for the whole batch (partitionable
threefry gives each device its rows of the global draw). This module gives the
port's training step the same three things while a :class:`DataShard` is current
(``data_shard``), each rank holding rows ``row0 .. row0 + rows`` of a global batch
of ``global_rows``:

* ``rand``: a random draw of the global shape, of which the rank keeps its rows
  (the batch is the first axis of every draw of a training step);
* ``sum_over_data``: a loss normaliser summed over the data axis, outside autograd;
* ``sum_over_data_with_grad``: the batch-norm sums, all-reduced with autograd
  (``batch_moments``);
* ``data_share``: a term every rank computes whole (the L2 regulariser), divided
  by the data axis's size, so that the ranks' shares sum to it;
* ``lane_offset``: the first global lane, which the teacher kernels' zoneout hash
  adds to the lane index.

With no shard current (one rank, synthesis, a replicated batch) each is the
plain operation, and no collective runs.

The collectives are ``all_reduce`` and ``all_gather`` (``all_reduce`` /
``all_gather`` here). gloo's process group takes both on CUDA tensors (two ranks on
one card share it under gloo, since NCCL refuses a duplicate device), so nothing is
staged through host memory.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataShard:
    row0: int            # the first global row this rank holds
    rows: int            # the rows it holds
    global_rows: int     # the rows of the global batch
    size: int            # the ranks of the data axis
    group: object        # the data axis's process group


_current: Optional[DataShard] = None


@contextlib.contextmanager
def data_shard(shard: Optional[DataShard]):
    """Make ``shard`` current for the block (None: the plain operations)."""
    global _current
    previous, _current = _current, shard
    try:
        yield shard
    finally:
        _current = previous


def current() -> Optional[DataShard]:
    return _current


def lane_offset() -> int:
    """The global index of this rank's first row (0 with no shard current)."""
    return 0 if _current is None else _current.row0


def rand(shape: Sequence[int], device, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``torch.rand(shape)``; with a shard current, this rank's rows of a draw of the
    global batch, so that every rank consumes the generator as one device would."""
    shard = _current
    if shard is None:
        return torch.rand(tuple(shape), device=device, generator=generator)
    if shape[0] != shard.rows:
        raise ValueError(
            f"a draw of shape {tuple(shape)} inside a data-parallel step must have the "
            f"rank's {shard.rows} rows first"
        )
    whole = torch.rand((shard.global_rows, *shape[1:]), device=device, generator=generator)
    return whole[shard.row0 : shard.row0 + shard.rows]


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``group``, in place; returned."""
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors concatenated along axis 0, in rank order."""
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def sum_over_data(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data axis, outside autograd (a loss's normaliser)."""
    shard = _current
    if shard is None:
        return x
    return all_reduce(x.detach().clone(), shard.group)


class _SumWithGrad(torch.autograd.Function):
    """An all-reduce sum whose backward all-reduces the cotangent: each rank's loss is
    its share of the global loss, so the global sum's gradient is the sum of theirs.
    ``torch.distributed.nn.functional.all_reduce`` does the same but warns at its first
    use that it is deprecated (PyTorch 2.13), and the successor it names,
    ``_functional_collectives.all_reduce``, has no autograd."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.detach().clone(), ctx.group), None


def sum_over_data_with_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data axis, with autograd (the batch-norm sums)."""
    shard = _current
    if shard is None:
        return x
    return _SumWithGrad.apply(x, shard.group)


def data_share(x: torch.Tensor) -> torch.Tensor:
    """``x``, which every rank computes whole, as this rank's share of it."""
    shard = _current
    return x if shard is None else x / shard.size


def batch_moments(x: torch.Tensor, dims: Sequence[int]):
    """(mean, E[x^2] - mean^2) of the global batch over ``dims`` of ``x`` (batch first),
    from sums of ``x`` and ``x^2`` all-reduced over the data axis with autograd; every
    rank holds the same number of rows."""
    shard = _current
    sums = sum_over_data_with_grad(torch.stack([x.sum(dim=dims), (x * x).sum(dim=dims)]))
    count = shard.size
    for d in dims:
        count *= x.shape[d]
    mean = sums[0] / count
    return mean, (sums[1] / count - mean * mean).clamp_min(0.0)
