"""The bit-moving transport under the port's collectives: JAX's tiled
``lax.all_to_all``, ``lax.all_gather`` and ``lax.psum_scatter`` /
``lax.psum`` over an :class:`~repro_torch.parallel.mesh.AxisGroup`, with
no autograd (``repro_torch.core.collectives`` adds the transposes).

Everything is built on one ``torch.distributed`` primitive,
``all_to_all_single``, for every backend (``all_to_all_rows``, the
placed expert weights' exchange, is that primitive with split sizes):

  * an AllGather is an AlltoAll of ``n`` copies of the payload;
  * a reduce-scatter is an AlltoAll followed by a sum over the source
    ranks, in the JAX index order of the sources, on the receiving rank;
  * an AllReduce is that reduce-scatter over a flattened payload followed
    by an AllGather of the reduced pieces, so every member holds the same
    bits;
  * a max all-reduce (``pmax``) is an AllGather and a max on every member.

So NCCL and gloo move the same bits and sum in the same order, and no
reduction runs inside the backend.  The payload crosses the backend as a
``uint8`` view of its bytes (gloo accepts few dtypes, and no fp8): a move
is bit-preserving by construction, whatever dtypes the backend can
reduce.  Chunks are permuted by the group's ``order`` so that
an axis tuple whose order differs from the mesh's moves data as JAX's
collective over that tuple does (see ``repro_torch.parallel.mesh``).
"""

from __future__ import annotations

import functools
import time

import torch

#: host-side timing of the collectives, off by default (``timing(True)``):
#: name -> [calls, bytes in, seconds]; a call inside another (``psum``'s
#: reduce-scatter and AllGather) counts to the outermost
_TIMES = None
_DEPTH = 0


def timing(on: bool) -> None:
    """Start (clearing) or stop timing the collectives on this rank.  A
    timed call synchronizes the device before and after it, so the time
    is the collective's own on the host's clock, staging included."""
    global _TIMES
    _TIMES = {} if on else None


def times() -> dict:
    """The timed collectives: name -> (calls, bytes in, seconds)."""
    return {k: tuple(v) for k, v in (_TIMES or {}).items()}


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _timed(fn):
    @functools.wraps(fn)
    def wrapper(x, grp, *args, **kw):
        global _DEPTH
        if _TIMES is None or _DEPTH or grp.size == 1:
            return fn(x, grp, *args, **kw)
        _sync(x)
        t0 = time.perf_counter()
        _DEPTH += 1
        try:
            out = fn(x, grp, *args, **kw)
        finally:
            _DEPTH -= 1
        _sync(out)
        rec = _TIMES.setdefault(fn.__name__, [0, 0, 0.0])
        rec[0] += 1
        rec[1] += x.numel() * x.element_size()
        rec[2] += time.perf_counter() - t0
        return out
    return wrapper


def _exchange(send, grp):
    """(n, ...) chunks in JAX destination order -> (n, ...) received
    chunks in JAX source order, over ``grp`` (one ``all_to_all_single``)."""
    import torch.distributed as dist
    order = grp.order
    if not grp.identity_order:
        send = send[list(order)]
    send = send.contiguous()
    recv = torch.empty_like(send)
    # bytes: chunk g of the (n, ...) buffers stays chunk g of the views
    dist.all_to_all_single(recv.view(torch.uint8), send.view(torch.uint8),
                           group=grp.pg)
    if not grp.identity_order:
        inv = [0] * len(order)
        for pos, j in enumerate(order):
            inv[j] = pos
        recv = recv[inv]
    return recv


@_timed
def all_to_all(x, grp, split_axis: int, concat_axis: int):
    """JAX's ``lax.all_to_all(x, axes, split_axis, concat_axis,
    tiled=True)``: ``x`` cut into ``n`` chunks along ``split_axis``, chunk
    ``j`` to the member of JAX index ``j``; the chunks received are joined
    along ``concat_axis`` in source order."""
    n = grp.size
    if n == 1:
        return x
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)}"
                         f" is not divisible by the group's {n} ranks")
    xs = x.movedim(split_axis, 0)
    xs = xs.reshape(n, xs.shape[0] // n, *xs.shape[1:])
    recv = _exchange(xs, grp)
    if split_axis == concat_axis:
        out = recv.reshape(-1, *recv.shape[2:])
        return out.movedim(0, split_axis)
    return torch.cat([recv[j].movedim(0, split_axis) for j in range(n)],
                     dim=concat_axis)


@_timed
def all_to_all_rows(x, grp, send_rows, recv_rows):
    """A ragged AlltoAll of rows: ``x`` holds ``send_rows[j]`` rows for
    the member of JAX index ``j``, in that order; returns the rows
    received, ``recv_rows[j]`` of them from the member of JAX index
    ``j``, in that order.  Both count lists are known on both sides (the
    callers derive them from one host-side table), so one
    ``all_to_all_single`` with split sizes moves exactly those rows, a
    zero-row chunk moving nothing."""
    import torch.distributed as dist
    n = grp.size
    if n == 1:
        return x
    tail = x.shape[1:]
    row = x.element_size()
    for d in tail:
        row *= d
    off = [0]
    for c in send_rows:
        off.append(off[-1] + c)
    # the backend's position p is the member of JAX index order[p]
    chunks = [x.narrow(0, off[grp.order[p]], send_rows[grp.order[p]])
              for p in range(n)]
    send = torch.cat(chunks).contiguous()
    n_recv = [recv_rows[grp.order[p]] for p in range(n)]
    buf = x.new_empty((sum(n_recv), *tail))
    dist.all_to_all_single(buf.reshape(-1).view(torch.uint8),
                           send.reshape(-1).view(torch.uint8),
                           [c * row for c in n_recv],
                           [send_rows[grp.order[p]] * row for p in range(n)],
                           group=grp.pg)
    if grp.identity_order:
        return buf
    at, pos = {}, 0
    for p in range(n):
        at[grp.order[p]] = (pos, n_recv[p])
        pos += n_recv[p]
    return torch.cat([buf.narrow(0, *at[j]) for j in range(n)])


@_timed
def all_gather(x, grp, axis: int, tiled: bool = True):
    """JAX's ``lax.all_gather(x, axes, axis=axis, tiled=tiled)``: every
    member's ``x`` in JAX index order, joined along ``axis`` (tiled) or
    stacked on a new dim at ``axis`` (untiled)."""
    n = grp.size
    if n == 1:
        return x if tiled else x.unsqueeze(axis)
    recv = _exchange(x.unsqueeze(0).expand(n, *x.shape), grp)
    if not tiled:
        return recv.movedim(0, axis % (x.dim() + 1))
    axis %= x.dim()
    out = recv.movedim(0, axis)
    return out.reshape(*x.shape[:axis], n * x.shape[axis],
                       *x.shape[axis + 1:])


def ordered_sum(parts):
    """``parts[0] + parts[1] + ...``, left to right: one fixed order on
    every device and backend."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


@_timed
def psum_scatter(x, grp, axis: int, tiled: bool = True):
    """JAX's ``lax.psum_scatter(x, axes, scatter_dimension=axis,
    tiled=tiled)``: the sum over the members of their ``x``, of which this
    rank keeps block ``index`` along ``axis`` (tiled: ``x.shape[axis] /
    n`` rows; untiled: ``x.shape[axis] == n``, the dim dropped).  Built as
    an AlltoAll and a sum over the sources in JAX index order."""
    n = grp.size
    if n == 1:
        return x if tiled else x.squeeze(axis)
    axis %= x.dim()
    xs = x.movedim(axis, 0)
    xs = xs.reshape(n, xs.shape[0] // n, *xs.shape[1:])
    recv = _exchange(xs, grp)                  # (n sources, rows, ...)
    red = ordered_sum(list(recv.unbind(0)))
    if not tiled:
        return red.squeeze(0)
    return red.movedim(0, axis)


@_timed
def psum(x, grp):
    """JAX's ``lax.psum(x, axes)``: every member holds the same bits of the
    sum, taken in JAX index order of the sources."""
    n = grp.size
    if n == 1:
        return x
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    red = psum_scatter(flat, grp, 0)
    return all_gather(red, grp, 0)[:x.numel()].reshape(x.shape)


@_timed
def pmax(x, grp):
    """JAX's ``lax.pmax(x, axes)``: the elementwise max over the members,
    the same bits on each (an AllGather, then the max over the members in
    JAX index order).  No autograd: callers apply it to a detached value
    (the vocab-parallel log-sum-exp's shift)."""
    if grp.size == 1:
        return x
    return all_gather(x, grp, 0, tiled=False).amax(dim=0)


def agree(values, grp, what: str, device="cpu") -> list:
    """All-gather ``values`` (a few ints) over ``grp`` and raise, on every
    member alike, unless every member holds the same ones: a decision that
    every rank makes on its own (a schedule, a guard's action, a
    checkpoint's step) is held to being one decision.  Every member gets
    every member's values, so all raise together and none is left waiting
    in a later collective.  Returns the gathered rows, in JAX index
    order."""
    mine = torch.tensor(list(values), dtype=torch.int64, device=device)
    rows = all_gather(mine, grp, 0, tiled=False).tolist() \
        if grp.size > 1 else [mine.tolist()]
    if any(r != rows[0] for r in rows):
        raise RuntimeError(f"ranks disagree on {what}: {rows}")
    return rows


def broadcast_first(values, grp, device="cpu") -> list:
    """The ``values`` (a few host floats, one count on every member) of the
    member of JAX index 0, on every member: one AllGather of float64s,
    of which every member keeps the first row.  A decision that reads a
    clock reads the first member's on every rank."""
    mine = torch.tensor(list(values), dtype=torch.float64, device=device)
    if grp.size == 1:
        return mine.tolist()
    return all_gather(mine, grp, 0, tiled=False)[0].tolist()


def gather_first(x, grp, senders) -> list:
    """The ``x`` of each member whose ``senders`` entry (by JAX index) is
    true, on the member of JAX index 0, as a list in JAX index order (None
    for a member that sent nothing); None on every other member.  One
    ``all_to_all_single`` whose other chunks are empty, so the other
    members receive nothing.  ``x`` has one shape on every member."""
    import torch.distributed as dist
    n = grp.size
    if n == 1:
        return [x]
    flat = x.contiguous().reshape(-1).view(torch.uint8)
    nb = flat.numel()
    first = grp.index == 0
    mine = bool(senders[grp.index])
    send = [nb if grp.order[p] == 0 and mine else 0 for p in range(n)]
    recv = [nb if first and senders[grp.order[p]] else 0 for p in range(n)]
    buf = flat.new_empty(sum(recv))
    dist.all_to_all_single(buf, flat if mine else flat[:0], recv, send,
                           group=grp.pg)
    if not first:
        return None
    out, off = [None] * n, 0
    for p in range(n):
        if recv[p]:
            out[grp.order[p]] = buf[off:off + nb].view(x.dtype).view(x.shape)
            off += nb
    return out
