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
    backward;
  * :func:`gather_features`: a column-parallel product's columns into
    every column, on every MP rank (the recurrent cells' ``w_dt`` and
    ``wq``/``wk``/``wv`` read every channel): AllGather along the last
    dim forward, reduce-scatter backward;
  * :func:`exchange_columns`: a ``[x | z]`` product whose ``P(None, mp)``
    columns give rank ``r`` block ``r`` of the concatenation into this
    rank's slice of ``x`` and of ``z`` (Mamba's ``in_proj``, mLSTM's
    ``up_proj``), moving only the blocks that change owner (one
    collective-permute, ``comm.permute_rows``); the inverse exchange
    backward;
  * :func:`all_reduce_mp`: ``psum`` both ways, for a partial sum whose
    consumers on each rank give only part of its cotangent (Mamba's
    ``B``/``C`` from row-parallel ``w_bc``, read by this rank's channels
    only).

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


FEATURE_DIM = -1


class _GatherFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return comm.all_gather(x.contiguous(), grp, FEATURE_DIM)

    @staticmethod
    def backward(ctx, g):
        return comm.psum_scatter(g.contiguous(), ctx.grp, FEATURE_DIM), None


def _column_moves(n: int, inverse: bool):
    """Block ``j`` of ``[x | z]`` cut into ``2n`` blocks of ``Di / n``
    columns is held after the ``P(None, mp)`` product by rank ``j // 2``
    at slot ``j % 2`` and owned by rank ``j % n`` at slot ``j // n`` (0:
    its slice of ``x``, 1: of ``z``).  Returns ``(from rank, from slot,
    to rank, to slot)`` per block, in ``j`` order (backward: owned to
    held)."""
    out = []
    for j in range(2 * n):
        held, owned = (j // 2, j % 2), (j % n, j // n)
        out.append((*owned, *held) if inverse else (*held, *owned))
    return out


def _exchange(x, grp, inverse: bool):
    n, me = grp.size, grp.index
    c = x.shape[-1] // 2
    blocks = x.unflatten(-1, (2, c)).movedim(-2, 0)       # (2, ..., c)
    moves = _column_moves(n, inverse)
    out, send = [None, None], []
    n_send, n_recv, recv_slots = [0] * n, [0] * n, []
    for peer in range(n):                 # rows by peer, then by block
        for src, sk, dst, dk in moves:
            if src == me and dst == peer:
                if peer == me:
                    out[dk] = blocks[sk]
                else:
                    send.append(blocks[sk])
                    n_send[peer] += 1
            if dst == me and src == peer != me:
                recv_slots.append(dk)
                n_recv[peer] += 1
    if recv_slots:
        got = comm.permute_rows(torch.stack(send), grp, n_send, n_recv)
        for dk, b in zip(recv_slots, got.unbind(0)):
            out[dk] = b
    return torch.cat(out, dim=-1)


class _ExchangeColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _exchange(x, grp, inverse=False)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.grp, inverse=True), None


def gather_features(x, grp: AxisGroup):
    """AllGather along the last dim forward (every rank's columns in MP
    order); reduce-scatter along it backward."""
    return x if grp.size == 1 else _GatherFeatures.apply(x, grp)


def exchange_columns(x, grp: AxisGroup):
    """This rank's ``(..., 2 Di / n)`` block of a ``[x | z]`` product
    (``P(None, mp)`` columns of a (D, 2 Di) weight) as ``[x_r | z_r]``,
    its slices of ``x`` and of ``z``; the inverse exchange backward.  At
    MP 2 rank 0 holds all of ``x`` and keeps half, rank 1 all of ``z``:
    each sends the other half of its block."""
    if grp.size == 1:
        return x
    if x.shape[-1] % 2:
        raise ValueError(f"exchange_columns: {x.shape[-1]} columns are not "
                         "two equal halves")
    return _ExchangeColumns.apply(x, grp)


def all_reduce_mp(x, grp: AxisGroup):
    """``psum`` over ``grp`` forward and backward: a partial sum (a
    row-parallel product) whose consumers on each rank give part of its
    cotangent.  ``reduce_from_mp`` alone would hand each rank only its
    own part."""
    return copy_to_mp(reduce_from_mp(x, grp), grp)


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
