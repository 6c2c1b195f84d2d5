"""Megatron tensor parallelism over the MP axes: the operators that take
activations into and out of a region whose weights are sharded over MP,
each an ``autograd.Function`` on ``repro_torch.parallel.comm``.

The JAX package writes the dense layers' sharding as partition specs and
leaves the collectives to GSPMD; the port writes them out.  A tensor
replicated over MP carries its whole cotangent on every MP rank (the
convention ``apply_moe``'s boundary keeps too); a partial sum, such as a
row-parallel product, carries the cotangent of the sum.  So:

  * :func:`copy_to_mp`: identity forward, ``psum`` over MP backward (the
    input of a column-parallel product, whose ranks each give part of its
    cotangent);
  * :func:`reduce_from_mp`: ``psum`` forward, identity backward (the
    output of a row-parallel product);
  * :func:`gather_from_seq` / :func:`scatter_to_seq`: their Megatron-SP
    forms on a residual stream sharded along L (dim 1) over MP: AllGather
    forward and reduce-scatter backward, reduce-scatter forward and
    AllGather backward;
  * :func:`gather_seq` / :func:`split_to_seq`: an L-sharded stream into a
    replicated consumer that returns whole cotangents (the MoE layer, a
    replicated LM head) and back: AllGather forward and this rank's slice
    of the cotangent backward, this rank's slice forward and AllGather
    backward.

Every sum runs in JAX's source order (``comm.psum``, ``comm.psum_scatter``),
so the MP replicas of a value hold the same bits.  :class:`TensorParallel`
is one rank's place in the MP group and picks the operators for the
residual stream's layout (replicated, or L-sharded under ``seq_parallel``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.parallel import comm
from repro_torch.parallel.mesh import AxisGroup, axis_size

SEQ_DIM = 1     # (B, L, D) activations


class _CopyToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.psum(g.contiguous(), ctx.grp), None


class _ReduceFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        return comm.psum(x.contiguous(), grp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return comm.all_gather(x.contiguous(), grp, SEQ_DIM)

    @staticmethod
    def backward(ctx, g):
        return comm.psum_scatter(g.contiguous(), ctx.grp, SEQ_DIM), None


class _ScatterToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return comm.psum_scatter(x.contiguous(), grp, SEQ_DIM)

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g.contiguous(), ctx.grp, SEQ_DIM), None


def _slice(x, grp):
    n = x.shape[SEQ_DIM] // grp.size
    return x.narrow(SEQ_DIM, grp.index * n, n).contiguous()


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return comm.all_gather(x.contiguous(), grp, SEQ_DIM)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.grp), None


class _SplitToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _slice(x, grp)

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g.contiguous(), ctx.grp, SEQ_DIM), None


def copy_to_mp(x, grp: AxisGroup):
    """Identity forward; the cotangent ``psum``-ed over ``grp`` backward."""
    return x if grp.size == 1 else _CopyToMP.apply(x, grp)


def reduce_from_mp(x, grp: AxisGroup):
    """``psum`` over ``grp`` forward; the cotangent as it is backward."""
    return x if grp.size == 1 else _ReduceFromMP.apply(x, grp)


def gather_from_seq(x, grp: AxisGroup):
    """AllGather along L forward; reduce-scatter along L backward."""
    return x if grp.size == 1 else _GatherFromSeq.apply(x, grp)


def scatter_to_seq(x, grp: AxisGroup):
    """Reduce-scatter along L forward; AllGather along L backward."""
    return x if grp.size == 1 else _ScatterToSeq.apply(x, grp)


def gather_seq(x, grp: AxisGroup):
    """AllGather along L forward; this rank's L-slice of the cotangent
    backward."""
    return x if grp.size == 1 else _GatherSeq.apply(x, grp)


def split_to_seq(x, grp: AxisGroup):
    """This rank's L-slice forward; AllGather along L backward."""
    return x if grp.size == 1 else _SplitToSeq.apply(x, grp)


@dataclass(frozen=True)
class TensorParallel:
    """This rank's MP group and the residual stream's layout over it:
    replicated, or sharded along L (``seq``, Megatron-SP).

    ``enter`` / ``leave`` wrap a region whose products are sharded over MP
    (column-parallel in, row-parallel out); ``to_replicated`` /
    ``from_replicated`` wrap a consumer that takes the whole sequence,
    replicated over MP, and returns whole cotangents (the MoE layer, a
    dense layer too narrow to shard).  Without ``seq`` the last two are
    the identity."""
    grp: AxisGroup
    seq: bool = False

    @property
    def n(self) -> int:
        return self.grp.size

    @property
    def index(self) -> int:
        return self.grp.index

    def enter(self, x):
        return gather_from_seq(x, self.grp) if self.seq \
            else copy_to_mp(x, self.grp)

    def leave(self, x):
        return scatter_to_seq(x, self.grp) if self.seq \
            else reduce_from_mp(x, self.grp)

    def to_replicated(self, x):
        return gather_seq(x, self.grp) if self.seq else x

    def from_replicated(self, x):
        return split_to_seq(x, self.grp) if self.seq else x

    def rows(self, t, dim: int = 0):
        """This rank's L-slice of ``t`` along ``dim`` under ``seq``
        (e.g. the position table), else ``t``."""
        if not self.seq:
            return t
        n = t.shape[dim] // self.n
        return t.narrow(dim, self.index * n, n)


def tensor_parallel(mesh, dims, seq_len: int,
                    seq_parallel: bool = False):
    """The :class:`TensorParallel` of this rank on ``mesh`` (None without a
    mesh or on one MP rank).  Megatron-SP applies where ``seq_parallel``
    is set and ``seq_len`` divides over MP: JAX's condition."""
    if mesh is None or axis_size(mesh, dims.mp) <= 1:
        return None
    grp = mesh.group(dims.mp)
    return TensorParallel(grp, seq=bool(seq_parallel)
                          and seq_len % grp.size == 0)
