"""Collectives of the multi-device path on `torch.distributed`.

Only `all_reduce` (SUM, MAX) and `broadcast` are used: gloo implements no
other collective on CUDA tensors, and gloo is what runs several ranks on one
card and the CPU tests. A gather is an all-reduce into per-rank slots of one
zeroed buffer (each slot has one writer, so the sum is exact), and a
reduce-scatter is an all-reduce of which each rank keeps its own slot.

An `Axis` names the ranks one reduction spans (a segment's tile ranks, or
the whole mesh) and this rank's index among them. Its `group` is None in a
process without torch.distributed: every collective is then the identity,
so the same code runs in one process.

The autograd collectives carry gradients across ranks, as the transposes
of JAX's collectives do:
- `exchange_row_halos`: the neighbours' boundary rows in the forward; the
  halo rows' gradient sent back to their owners in the backward;
- `all_reduce_sum`: a sum in the forward and in the backward, for a sum
  whose replicated result feeds a nonlinear function on every rank;
- `gather_rows`: every rank's rows in the forward; in the backward each
  rank receives the sum over ranks of its rows' cotangents.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    group: Optional[object]     # a ProcessGroup, or None in one process
    index: int                  # this rank's place along the axis
    size: int

    def all_reduce_(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place all-reduce of x over the axis; returns x."""
        if self.group is not None:
            dist.all_reduce(x, op=dist.ReduceOp.SUM if op == "sum"
                            else dist.ReduceOp.MAX, group=self.group)
        return x


SINGLE = Axis(None, 0, 1)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce_(g.clone()), None


def all_reduce_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Differentiable sum over the axis. Each rank that differentiates a
    share of a loss built on the replicated sum receives, through the
    backward's sum, the cotangent of the whole loss."""
    return _AllReduceSum.apply(x, axis)


class _RowHalos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, halo):
        ctx.axis, ctx.halo = axis, halo
        i, n = axis.index, axis.size
        buf = x.new_zeros((n, 2, halo) + tuple(x.shape[1:]))
        buf[i, 0] = x[:halo]
        buf[i, 1] = x[-halo:]
        axis.all_reduce_(buf)
        top = buf[i - 1, 1] if i > 0 else torch.zeros_like(buf[i, 0])
        bot = buf[i + 1, 0] if i < n - 1 else torch.zeros_like(buf[i, 0])
        return torch.cat([top, x, bot], dim=0)

    @staticmethod
    def backward(ctx, g):
        axis, h = ctx.axis, ctx.halo
        i, n = axis.index, axis.size
        buf = g.new_zeros((n, 2, h) + tuple(g.shape[1:]))
        if i > 0:
            buf[i - 1, 1] = g[:h]
        if i < n - 1:
            buf[i + 1, 0] = g[-h:]
        axis.all_reduce_(buf)
        dx = g[h:-h].clone()
        dx[:h] += buf[i, 0]
        dx[-h:] += buf[i, 1]
        return dx, None, None


def exchange_row_halos(x: torch.Tensor, axis: Axis, halo: int
                       ) -> torch.Tensor:
    """[bh, ...] row block -> [bh + 2 halo, ...] with the neighbours'
    boundary rows attached; blocks lie in axis order down the image, and
    the image's top and bottom get zeros, as a convolution's padding."""
    if x.shape[0] < halo:
        raise ValueError(f"a block of {x.shape[0]} rows cannot lend a "
                         f"{halo}-row halo")
    return _RowHalos.apply(x, axis, halo)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        buf = x.new_zeros((axis.size,) + tuple(x.shape))
        buf[axis.index] = x
        axis.all_reduce_(buf)
        return buf.reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        g = axis.all_reduce_(g.contiguous().clone())
        return g.reshape(axis.size, -1, *g.shape[1:])[axis.index], None


def gather_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """[R, ...] on every rank -> [size * R, ...], rank-major, the same on
    every rank. The backward is a reduce-scatter: each rank's rows get the
    sum over ranks of their cotangents."""
    return _GatherRows.apply(x, axis)


def broadcast_bytes(data: Optional[bytes], src: int, device,
                    group=None) -> bytes:
    """Rank `src`'s bytes on every rank of the group (two broadcasts on
    `device`: the length, then the bytes). Identity in one process."""
    if not dist.is_initialized():
        return data
    n = torch.tensor([len(data) if data is not None else 0],
                     dtype=torch.int64, device=device)
    dist.broadcast(n, src=src, group=group)
    if int(n.item()) == 0:
        return b""
    if data is not None and dist.get_rank() == src:
        buf = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)
    else:
        buf = torch.empty(int(n.item()), dtype=torch.uint8, device=device)
    dist.broadcast(buf, src=src, group=group)
    return buf.cpu().numpy().tobytes()


# counters as float32 pairs (high and low 12 bits) so that they ride in
# a float32 buffer's sum exactly: each half stays far below 2^24
_LOW = 4096


def pack_counts(counts) -> torch.Tensor:
    c = torch.stack([torch.as_tensor(x).reshape(()).to(torch.int64)
                     for x in counts])
    return torch.cat([(c // _LOW).float(), (c % _LOW).float()])


def unpack_counts(x: torch.Tensor):
    n = x.shape[0] // 2
    c = x[:n].to(torch.int64) * _LOW + x[n:].to(torch.int64)
    return list(c.unbind(0))
