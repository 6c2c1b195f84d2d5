"""The bit-moving transport under the port's collectives: JAX's tiled
``lax.all_to_all``, ``lax.all_gather`` and ``lax.psum_scatter`` /
``lax.psum`` over an :class:`~repro_torch.parallel.mesh.AxisGroup`, with
no autograd (``repro_torch.core.collectives`` adds the transposes).

Everything is built on one ``torch.distributed`` primitive,
``all_to_all_single``, for every backend (``all_to_all_rows``, the
placed expert weights' exchange, and ``permute_rows``, the Megatron
column exchange's collective-permute, are that primitive with split
sizes):

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

``all_to_all``, ``all_gather`` and ``psum_scatter`` have start forms
(``*_start``): the start posts ``all_to_all_single(..., async_op=True)``
and returns a :class:`Handle`, whose ``wait()`` waits and only then runs
the post-processing (the inverse ``order`` permutation, the sum over the
sources, the reshapes).  Each synchronous form is its start followed by
the wait, so several collectives can be in flight at once and a caller
that waits at once gets the same bits.  A one-member group posts nothing
and returns a completed handle.  ``all_to_all_rows``, ``permute_rows``,
``agree``, ``broadcast_first``, ``gather_first``, ``psum`` and ``pmax``
stay synchronous.  A hook (:func:`set_hook`) sees every start and wait with
its group, kind and tag (:func:`tagged`): how the tests read how many
collectives were in flight.  Collectives posted to one group must start
in one order on every member; the callers issue them in an order fixed
by the plan, never by which one finished first.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch

#: host-side timing of the collectives, off by default (``timing(True)``):
#: name -> [calls, bytes in, seconds, {group axes: bytes out},
#: {group axes: calls}]; a call inside another (``psum``'s reduce-scatter
#: and AllGather) counts to the outermost; ``in_flight`` -> [spans, 0, wall
#: seconds during which one or more was in flight, {}, {}]
_TIMES = None
_DEPTH = 0
#: timed collectives in flight, and when the first of them started
_OPEN = [0, 0.0]
#: per thread: the tag of the stage being issued (``tagged``) and the
#: handles posted inside ``collecting``
_LOCAL = threading.local()
_HOOK = None


def timing(on: bool) -> None:
    """Start (clearing) or stop timing the collectives on this rank.  A
    collective is timed from its start to the end of its wait on the
    host's clock, staging included: the device is synchronized before a
    start when no other timed collective is in flight, and after each
    wait, so the collectives of an overlapped issue stay in flight
    together (a start posted behind queued kernels counts their time).
    Beside each kind's summed seconds, ``in_flight`` holds the wall
    seconds during which at least one timed collective was in flight:
    the summed seconds less those are what overlap hid."""
    global _TIMES
    _TIMES = {} if on else None
    _OPEN[0] = 0


def times() -> dict:
    """The timed collectives: name -> (calls, bytes in, seconds), and
    ``in_flight`` -> (spans, 0, wall seconds with one or more in
    flight)."""
    return {k: tuple(v[:3]) for k, v in (_TIMES or {}).items()}


def bytes_out() -> dict:
    """The timed collectives' result bytes: name -> {group axes: bytes
    this rank received} (an AllGather's whole result, a reduce-scatter's
    block: the size XLA's HLO gives a collective)."""
    return {k: dict(v[3]) for k, v in (_TIMES or {}).items()
            if k != "in_flight"}


def calls_out() -> dict:
    """The timed collectives' calls by group: name -> {group axes: calls
    on this rank} (beside :func:`bytes_out`'s bytes)."""
    return {k: dict(v[4]) for k, v in (_TIMES or {}).items()
            if k != "in_flight"}


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _open(x) -> float:
    """A timed collective starts (synchronizing when none is in flight);
    returns its start time."""
    if not _OPEN[0]:
        _sync(x)
    t0 = time.perf_counter()
    if not _OPEN[0]:
        _OPEN[1] = t0
    _OPEN[0] += 1
    return t0


def _close(name, x, out, t0, axes=()) -> None:
    """A timed collective ends: add it to ``name``, and close the span
    when it was the last in flight."""
    _sync(out)
    now = time.perf_counter()
    rec = _TIMES.setdefault(name, [0, 0, 0.0, {}, {}])
    rec[0] += 1
    rec[1] += x.numel() * x.element_size()
    rec[2] += now - t0
    rec[3][axes] = rec[3].get(axes, 0) + out.numel() * out.element_size()
    rec[4][axes] = rec[4].get(axes, 0) + 1
    _OPEN[0] -= 1
    if not _OPEN[0]:
        span = _TIMES.setdefault("in_flight", [0, 0, 0.0, {}, {}])
        span[0] += 1
        span[2] += now - _OPEN[1]


def _timed(fn):
    @functools.wraps(fn)
    def wrapper(x, grp, *args, **kw):
        global _DEPTH
        if _TIMES is None or _DEPTH or grp.size == 1:
            return fn(x, grp, *args, **kw)
        t0 = _open(x)
        _DEPTH += 1
        try:
            out = fn(x, grp, *args, **kw)
        finally:
            _DEPTH -= 1
        _close(fn.__name__, x, out, t0, grp.axes)
        return out
    return wrapper


def set_hook(cb) -> None:
    """Install (or clear, with None) ``cb(event, axes, kind, tag)``,
    called at every start (``event == "start"``) and at the end of every
    wait (``"wait"``) of a collective posted to more than one member:
    ``axes`` the group's axis tuple, ``kind`` ``all_to_all``,
    ``all_gather`` or ``psum_scatter``, ``tag`` the :func:`tagged` tag
    at the start (or the one the start form was given)."""
    global _HOOK
    _HOOK = cb


@contextlib.contextmanager
def tagged(tag):
    """Tag the collectives this thread starts inside with ``tag``."""
    prev = getattr(_LOCAL, "tag", None)
    _LOCAL.tag = tag
    try:
        yield tag
    finally:
        _LOCAL.tag = prev


def current_tag():
    """The innermost :func:`tagged` tag on this thread, or None."""
    return getattr(_LOCAL, "tag", None)


@contextlib.contextmanager
def collecting():
    """Collect every :class:`Handle` this thread posts inside into the
    yielded list (``executor.execute`` checks it waited on each)."""
    prev = getattr(_LOCAL, "posted", None)
    _LOCAL.posted = posted = []
    try:
        yield posted
    finally:
        _LOCAL.posted = prev


class Handle:
    """One collective in flight, or a completed value.  ``wait()`` waits
    on the backend's ``Work`` (on NCCL a stream wait, on gloo a host wait
    and a stream sync), then runs the post-processing in order and
    returns the value; a later ``wait()`` returns it again.  Until then
    the handle holds the send and receive buffers."""

    __slots__ = ("_work", "_bufs", "_post", "value", "axes", "kind", "tag",
                 "_t0", "_x")

    def __init__(self, work, bufs, post, grp, kind, tag, t0, x):
        self._work, self._bufs, self._post = work, bufs, post
        self.value, self.axes, self.kind, self.tag = None, grp.axes, kind, tag
        self._t0, self._x = t0, x
        if _HOOK is not None:
            _HOOK("start", self.axes, kind, tag)
        posted = getattr(_LOCAL, "posted", None)
        if posted is not None:
            posted.append(self)

    @classmethod
    def completed(cls, value):
        """A handle that posted nothing (a one-member group)."""
        h = cls.__new__(cls)
        h._work, h._bufs, h._post, h.value = None, None, None, value
        h.axes, h.kind, h.tag, h._t0, h._x = (), None, None, None, None
        return h

    @property
    def done(self) -> bool:
        return self._work is None

    def then(self, fn):
        """Apply ``fn`` to the value after the wait; returns ``self``."""
        if self._work is None:
            self.value = fn(self.value)
        else:
            self._post.append(fn)
        return self

    def wait(self):
        if self._work is not None:
            self._work.wait()
            v = self._bufs[1]
            for fn in self._post:
                v = fn(v)
            self._work = self._bufs = self._post = None
            self.value = v
            if self._t0 is not None and _TIMES is not None:
                _close(self.kind, self._x, v, self._t0, self.axes)
            self._x = None
            if _HOOK is not None:
                _HOOK("wait", self.axes, self.kind, self.tag)
        return self.value


def _exchange_start(send, grp, kind, post, x, tag) -> Handle:
    """Post the exchange of (n, ...) chunks in JAX destination order over
    ``grp`` (one ``all_to_all_single(..., async_op=True)``); the handle's
    wait gives ``post`` of the (n, ...) chunks received, in JAX source
    order.  ``x`` is the caller's payload (timing counts its bytes)."""
    import torch.distributed as dist
    order = grp.order
    if not grp.identity_order:
        send = send[list(order)]
    send = send.contiguous()
    recv = torch.empty_like(send)
    steps = []
    if not grp.identity_order:
        inv = [0] * len(order)
        for pos, j in enumerate(order):
            inv[j] = pos
        steps.append(lambda r: r[inv])
    steps.append(post)
    t0 = _open(x) if _TIMES is not None and not _DEPTH else None
    # bytes: chunk g of the (n, ...) buffers stays chunk g of the flat
    # views (flat first: a contiguous tensor whose last dim has one
    # element may carry any stride there, which a dtype view refuses)
    work = dist.all_to_all_single(recv.reshape(-1).view(torch.uint8),
                                  send.reshape(-1).view(torch.uint8),
                                  group=grp.pg, async_op=True)
    return Handle(work, (send, recv), steps, grp, kind,
                  current_tag() if tag is None else tag, t0, x)


def all_to_all_start(x, grp, split_axis: int, concat_axis: int, *,
                     tag=None) -> Handle:
    """Start :func:`all_to_all`; the handle's wait gives its value."""
    n = grp.size
    if n == 1:
        return Handle.completed(x)
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)}"
                         f" is not divisible by the group's {n} ranks")
    xs = x.movedim(split_axis, 0)
    xs = xs.reshape(n, xs.shape[0] // n, *xs.shape[1:])

    def post(recv):
        if split_axis == concat_axis:
            out = recv.reshape(-1, *recv.shape[2:])
            return out.movedim(0, split_axis)
        return torch.cat([recv[j].movedim(0, split_axis) for j in range(n)],
                         dim=concat_axis)
    return _exchange_start(xs, grp, "all_to_all", post, x, tag)


def all_to_all(x, grp, split_axis: int, concat_axis: int):
    """JAX's ``lax.all_to_all(x, axes, split_axis, concat_axis,
    tiled=True)``: ``x`` cut into ``n`` chunks along ``split_axis``, chunk
    ``j`` to the member of JAX index ``j``; the chunks received are joined
    along ``concat_axis`` in source order."""
    return all_to_all_start(x, grp, split_axis, concat_axis).wait()


def _exchange_rows(x, grp, send_rows, recv_rows):
    """One ``all_to_all_single`` with split sizes: ``x`` holds
    ``send_rows[j]`` rows for the member of JAX index ``j``, in that
    order; returns the rows received, ``recv_rows[j]`` of them from the
    member of JAX index ``j``, in that order."""
    import torch.distributed as dist
    n = grp.size
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
def all_to_all_rows(x, grp, send_rows, recv_rows):
    """A ragged AlltoAll of rows: ``x`` holds ``send_rows[j]`` rows for
    the member of JAX index ``j``, in that order; returns the rows
    received, ``recv_rows[j]`` of them from the member of JAX index
    ``j``, in that order.  Both count lists are known on both sides (the
    callers derive them from one host-side table), so one
    ``all_to_all_single`` with split sizes moves exactly those rows, a
    zero-row chunk moving nothing."""
    return x if grp.size == 1 else _exchange_rows(x, grp, send_rows,
                                                  recv_rows)


@_timed
def permute_rows(x, grp, send_rows, recv_rows):
    """XLA's collective-permute, for a reshuffle whose every move is known
    on both sides: :func:`all_to_all_rows` where the rows a member keeps
    are not sent (``send_rows`` and ``recv_rows`` are 0 at its own
    index), so only the rows that change owner cross the group.  Counted
    apart from the AlltoAlls (``analysis.layerwise`` names it
    ``collective-permute``)."""
    if send_rows[grp.index] or recv_rows[grp.index]:
        raise ValueError("permute_rows: a member's own rows stay with it")
    return x if grp.size == 1 else _exchange_rows(x, grp, send_rows,
                                                  recv_rows)


def all_gather_start(x, grp, axis: int, tiled: bool = True, *,
                     tag=None) -> Handle:
    """Start :func:`all_gather`; the handle's wait gives its value."""
    n = grp.size
    if n == 1:
        return Handle.completed(x if tiled else x.unsqueeze(axis))

    def post(recv):
        if not tiled:
            return recv.movedim(0, axis % (x.dim() + 1))
        ax = axis % x.dim()
        out = recv.movedim(0, ax)
        return out.reshape(*x.shape[:ax], n * x.shape[ax], *x.shape[ax + 1:])
    return _exchange_start(x.unsqueeze(0).expand(n, *x.shape), grp,
                           "all_gather", post, x, tag)


def all_gather(x, grp, axis: int, tiled: bool = True):
    """JAX's ``lax.all_gather(x, axes, axis=axis, tiled=tiled)``: every
    member's ``x`` in JAX index order, joined along ``axis`` (tiled) or
    stacked on a new dim at ``axis`` (untiled)."""
    return all_gather_start(x, grp, axis, tiled).wait()


def ordered_sum(parts):
    """``parts[0] + parts[1] + ...``, left to right: one fixed order on
    every device and backend."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def psum_scatter_start(x, grp, axis: int, tiled: bool = True, *,
                       tag=None) -> Handle:
    """Start :func:`psum_scatter`; the wait sums the sources."""
    n = grp.size
    if n == 1:
        return Handle.completed(x if tiled else x.squeeze(axis))
    axis %= x.dim()
    xs = x.movedim(axis, 0)
    xs = xs.reshape(n, xs.shape[0] // n, *xs.shape[1:])

    def post(recv):                            # (n sources, rows, ...)
        # a meta tensor (the dry run) has no values to order: one sum
        red = recv.sum(0) if recv.is_meta else \
            ordered_sum(list(recv.unbind(0)))
        return red.squeeze(0) if not tiled else red.movedim(0, axis)
    return _exchange_start(xs, grp, "psum_scatter", post, x, tag)


def psum_scatter(x, grp, axis: int, tiled: bool = True):
    """JAX's ``lax.psum_scatter(x, axes, scatter_dimension=axis,
    tiled=tiled)``: the sum over the members of their ``x``, of which this
    rank keeps block ``index`` along ``axis`` (tiled: ``x.shape[axis] /
    n`` rows; untiled: ``x.shape[axis] == n``, the dim dropped).  Built as
    an AlltoAll and a sum over the sources in JAX index order."""
    return psum_scatter_start(x, grp, axis, tiled).wait()


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
