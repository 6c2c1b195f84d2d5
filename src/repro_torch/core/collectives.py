"""Parm's communication primitives on ``torch.distributed`` (counterpart
of ``repro/core/collectives.py``).

The JAX package issues its collectives as ``jax.lax`` ops inside a
shard_map body, over named mesh axes.  The port's run inside
:func:`bound`, which binds a :class:`~repro_torch.parallel.mesh.Mesh` as
shard_map binds its axes (``apply_moe(..., mesh=)`` binds one): an axis
tuple resolves to this rank's process group, and a collective over a
one-member group is the identity, as a ``lax`` collective over a size-1
axis is.  Where the JAX function reads its group size from the mesh, the
port's takes it as an argument and checks it against the mesh.

The data move under every collective is ``repro_torch.parallel.comm``'s
(one ``all_to_all_single``, sums in a fixed order on the receiving rank).
Each bit-moving collective has a start form (``*_start``) that returns a
:class:`Flight`: the collective posted, its value landed by ``wait()``.
Its autograd form is a chain of nodes (``_Post`` starts, ``_Relay`` waits
and starts the next hop, ``_Land`` waits), so several collectives are in
flight at once forward and, since the backward runs the chain in reverse
(the transpose started by one node and waited by another), backward too;
the plain form waits at once.  ``executor.execute`` issues the plan's
collectives through the start forms.
Each collective's backward is JAX's transpose, as ``jax.grad`` takes it
inside a ``shard_map(..., check_vma=False)``: an AlltoAll's is the
AlltoAll with split and concat swapped, a tiled AllGather's the
reduce-scatter, ``psum``'s ``psum``, and ``mp_split``'s (a slice) a
zero pad.  ``apply_moe`` adds the shard_map boundary's two rules
(cotangents of replicated outputs divided by the replication, input
cotangents summed over the axes the input is replicated on).

The wire codec runs as in JAX: a ``wire_*`` collective encodes its
payload (f32 identity, bf16 cast, fp8_e4m3 with a per-row absmax scale
bitcast into a 4-byte tail), moves it and decodes it, forward and
backward.  It is plain PyTorch: the codec is jnp in the JAX package, not
a TPU kernel.  On a one-member group the move is the identity and only
the codec runs.

The fp8 saturation monitor and fault injection of the JAX module
(``set_fp8_monitor``, ``set_fp8_sat_injection``) hook the fp8 encode at
the JAX module's points, and count this rank's own encodes; the guard
rails (``runtime/guards.py``) install the monitor.  The fp8 move's
backward re-encodes its cotangent under the call context of its forward
(``obs.trace_tag``), so a saturation event of the backward says which MoE
call it belongs to, as the forward's does.  The layout helpers (``dump``,
``undump_reduce``, ``to/from_expert_batch`` and the expert-major ``*_em``
twins) are the JAX module's reshapes, written for torch tensors.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from repro_torch import obs
from repro_torch.parallel import comm as _comm

#: the wire formats (``repro/core/perfmodel.py``'s constant, copied)
WIRE_DTYPES = ("f32", "bf16", "fp8_e4m3")


@dataclass(frozen=True)
class CommConfig:
    """Wire format for the MoE collectives.

    ``wire_dtype``: ``"f32"`` (no compression), ``"bf16"``,
    ``"fp8_e4m3"``, or ``"auto"`` (the JAX autoscheduler's pick; the port
    refuses it until the cost model is ported).  ``scaling`` applies to
    fp8 only: ``"per_chunk"`` rescales each M-row by its absmax;
    ``"none"`` casts directly and saturates at +-448.
    """

    wire_dtype: str = "f32"
    scaling: str = "per_chunk"

    def __post_init__(self):
        if self.wire_dtype not in WIRE_DTYPES + ("auto",):
            raise ValueError(f"unknown wire_dtype {self.wire_dtype!r}, "
                             f"want one of {WIRE_DTYPES + ('auto',)}")
        if self.scaling not in ("none", "per_chunk"):
            raise ValueError(f"unknown scaling {self.scaling!r}")


_FP8_MAX = 448.0   # largest finite float8_e4m3fn value
_SCALE_TAIL = 4    # fp8 payload rows carry their f32 scale as 4 extra bytes
_FP8 = torch.float8_e4m3fn


# --- fp8 wire overflow monitoring / fault injection --------------------------
# The guard rails (repro_torch.runtime.guards) install a monitor that
# accumulates (saturating, total) element counts from every fp8 encode,
# the backward's re-encodes included; the fault harness
# (repro_torch.runtime.faults) can shrink the scales so payloads saturate
# on demand.  With the defaults (None / 0.0) the encode runs no extra op.

_FP8_MONITOR = None      # callable(sat: 0-d int64 tensor, n_elements: int)
_FP8_SAT_INJECT = 0.0    # scale-shrink factor (0.0 = off)


def set_fp8_monitor(cb) -> None:
    """Install (or clear, with None) the process-wide fp8 saturation
    monitor.  It is called once per fp8 encode with the count of
    saturating elements as a tensor on the encode's device (no sync) and
    the element count."""
    global _FP8_MONITOR
    _FP8_MONITOR = cb


def set_fp8_sat_injection(factor: float) -> None:
    """Shrink fp8 wire-encode scales by ``factor`` so payloads saturate
    (deterministic overflow injection); 0.0 disables."""
    global _FP8_SAT_INJECT
    _FP8_SAT_INJECT = float(factor)


def _monitor_sat(vals) -> None:
    """Count the saturating or non-finite elements of a pre-cast fp8
    payload into the installed monitor (nothing when none is)."""
    if _FP8_MONITOR is None:
        return
    sat = ((~torch.isfinite(vals)) | (vals.abs() > _FP8_MAX)).sum()
    _FP8_MONITOR(sat, vals.numel())


def _active(comm) -> str:
    wd = getattr(comm, "wire_dtype", "f32") if comm is not None else "f32"
    if wd == "auto":
        raise ValueError("CommConfig.wire_dtype='auto' must be resolved "
                         "before reaching a collective")
    return wd


def wire_encode(x, comm: CommConfig | None):
    """Encode ``x`` into its wire format.  f32 is the identity; bf16 a
    cast; fp8_e4m3 a per-row (absmax over the trailing M dim) scale and
    cast, with the f32 scale bitcast into ``_SCALE_TAIL`` extra fp8
    elements appended along M.  Values are clipped to +-448 before the
    cast, as JAX clips them (e4m3fn has no inf)."""
    wd = _active(comm)
    if wd == "f32":
        return x
    if wd == "bf16":
        return x.to(torch.bfloat16)
    xf = x.float()
    if comm.scaling == "none":
        _monitor_sat(xf)
        return torch.clamp(xf, -_FP8_MAX, _FP8_MAX).to(_FP8)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # divide by a tensor, not a Python scalar: PyTorch's CUDA division by a
    # scalar multiplies by its rounded reciprocal, one ulp off the true
    # quotient that JAX (and PyTorch's CPU kernel) computes
    scale = (torch.clamp(amax, min=1e-30)
             / amax.new_full((), _FP8_MAX)).detach()
    if _FP8_SAT_INJECT:
        scale = scale / scale.new_full((), _FP8_SAT_INJECT)
    ratio = xf / scale
    _monitor_sat(ratio)
    # clip is the identity for in-range values and turns injected or
    # overflowed values into saturated but finite payloads
    payload = torch.clamp(ratio, -_FP8_MAX, _FP8_MAX).to(_FP8)
    sbits = scale.contiguous().view(torch.uint8).view(_FP8)  # (..., 4)
    return torch.cat([payload, sbits], dim=-1)


def wire_decode(w, comm: CommConfig | None, out_dtype):
    """Invert :func:`wire_encode` (the scale tail decodes exactly)."""
    wd = _active(comm)
    if wd in ("f32", "bf16") or comm.scaling == "none":
        return w.to(out_dtype)
    payload = w[..., :-_SCALE_TAIL]
    scale = w[..., -_SCALE_TAIL:].contiguous().view(torch.uint8).view(
        torch.float32)                                        # (..., 1)
    return (payload.float() * scale).to(out_dtype)


# --- collectives in flight -----------------------------------------------------
# A collective of this module moves its payload through one or more hops
# (a hop: one ``parallel.comm`` start form bound to a group, and its
# transpose's).  Its autograd form is a chain of nodes that share a _Box:
# _Post encodes the payload and starts hop 0; a _Relay per later hop waits
# on the one before and starts its own; _Land waits on the last and
# decodes.  The backward runs the chain in reverse: _Land's backward
# encodes the cotangent and starts the last hop's transpose, each _Relay's
# waits on it and starts the transpose of the hop before, and _Post's waits,
# decodes and applies ``bwd_post``.  So between the node that starts a
# transpose and the one that waits on it, the autograd engine may run other
# chunks' backward.  A Flight holds the forward chain as a generator that
# pauses while a collective is in flight.

class _Box:
    """What one collective's chain of nodes shares: its hops (pairs of
    ``start(v, tag)`` and ``transpose(v, tag)`` returning a
    ``comm.Handle``), the hops its backward moves through (fp8's
    ``bwd_move``), the codec, and the forward's and backward's handle in
    flight."""

    __slots__ = ("hops", "bwd_hops", "comm", "fp8", "dtype", "bwd_post",
                 "tag", "fwd", "bwd", "tok")

    def __init__(self, hops, comm, bwd_hops, bwd_post):
        self.hops, self.comm = hops, comm
        self.fp8 = _active(comm) == "fp8_e4m3"
        self.bwd_hops = bwd_hops if self.fp8 and bwd_hops else hops
        self.bwd_post = bwd_post if self.fp8 else None
        self.tag = _comm.current_tag()
        self.fwd = self.bwd = self.dtype = self.tok = None

    @property
    def bwd_tag(self):
        return None if self.tag is None else f"{self.tag}/bwd"


class _Post(torch.autograd.Function):
    """Encode (fp8; the f32 / bf16 casts run outside, as autograd ops)
    and start hop 0.  The output is an empty token for the next node."""

    @staticmethod
    def forward(ctx, x, box):
        ctx.box, box.dtype = box, x.dtype
        box.tok = (x.dtype, x.device)
        v = wire_encode(x, box.comm) if box.fp8 else x
        box.fwd = box.hops[0][0](v, box.tag)
        return x.new_empty(0)

    @staticmethod
    def backward(ctx, _):
        box = ctx.box
        g, box.bwd = box.bwd.wait(), None
        if box.fp8:
            g = wire_decode(g, box.comm, box.dtype)
            if box.bwd_post is not None:
                g = box.bwd_post(g)
        return g, None


class _Relay(torch.autograd.Function):
    """Wait on hop ``k - 1`` and start hop ``k``."""

    @staticmethod
    def forward(ctx, tok, box, k):
        ctx.box, ctx.k = box, k
        v = box.fwd.wait()
        box.fwd = box.hops[k][0](v, box.tag)
        return tok.new_empty(0)

    @staticmethod
    def backward(ctx, gt):
        box = ctx.box
        v = box.bwd.wait()
        box.bwd = box.bwd_hops[ctx.k - 1][1](v, box.bwd_tag)
        return gt, None, None


class _Land(torch.autograd.Function):
    """Wait on the last hop and decode (fp8).  The backward re-encodes
    the cotangent under the forward's call context (``obs.trace_tag``),
    so a saturation event of the backward names its MoE call."""

    @staticmethod
    def forward(ctx, tok, box):
        ctx.box = box
        ctx.tags = obs.trace_context() if box.fp8 and obs.enabled() else None
        v, box.fwd = box.fwd.wait(), None
        return wire_decode(v, box.comm, box.dtype) if box.fp8 else v

    @staticmethod
    def backward(ctx, g):
        box = ctx.box
        if box.fp8:
            with (obs.trace_tag(**ctx.tags) if ctx.tags
                  else contextlib.nullcontext()):
                g = wire_encode(g, box.comm)
        box.bwd = box.bwd_hops[-1][1](g, box.bwd_tag)
        dtype, device = box.tok
        return torch.empty(0, dtype=dtype, device=device), None


class Flight:
    """A collective's value in flight: ``wait()`` returns it.  Built on a
    generator that starts collectives and pauses (``yield``) while they
    are in flight; the constructor runs it to its first pause, each
    ``wait()`` to its end.  The generator runs under the ``comm.tagged``
    tag the flight was created under, whoever waits on it."""

    __slots__ = ("_gen", "_tag", "value")

    def __init__(self, gen):
        self._gen, self._tag, self.value = gen, _comm.current_tag(), None
        self._resume()

    @classmethod
    def of(cls, value):
        """A flight that has landed: ``value``."""
        f = cls.__new__(cls)
        f._gen, f._tag, f.value = None, None, value
        return f

    @property
    def done(self) -> bool:
        return self._gen is None

    def _resume(self):
        with _comm.tagged(self._tag):
            try:
                next(self._gen)
            except StopIteration as stop:
                self._gen, self.value = None, stop.value

    def wait(self):
        while self._gen is not None:
            self._resume()
        return self.value

    def then(self, fn):
        """The flight of ``fn(value)``, applied at the wait."""
        if self._gen is None:
            return Flight.of(fn(self.value))
        return Flight(_then(self, fn))


def _then(f, fn):
    yield f
    return fn(f.wait())


def landed(v):
    """``v``, waited on when it is a :class:`Flight`."""
    return v.wait() if isinstance(v, Flight) else v


def _fly(x, hops, comm, bwd_hops, bwd_post):
    box = _Box(hops, comm, bwd_hops, bwd_post)
    tok = _Post.apply(x if box.fp8 else wire_encode(x, comm), box)
    for k in range(1, len(hops)):
        yield box.fwd
        tok = _Relay.apply(tok, box, k)
    yield box.fwd
    out = _Land.apply(tok, box)
    return out if box.fp8 else wire_decode(out, comm, x.dtype)


def _flight(x, hops, comm=None, *, bwd_hops=None, bwd_post=None) -> Flight:
    """Start moving ``x`` through ``hops`` in the wire format, with the
    backward in the same wire dtype: f32 moves ``x`` raw, bf16 casts
    around the move (autograd transposes the casts), fp8 encodes in the
    chain with its own absmax scales, forward and backward.  fp8's
    backward moves through ``bwd_hops`` when given (an AlltoAll where the
    transpose is a reduce-scatter) and then applies ``bwd_post`` (the
    local sum that the reduce-scatter would take).  No hops (a
    one-member group) runs the codec alone."""
    if not hops:
        if _active(comm) != "fp8_e4m3":
            return Flight.of(wire_decode(wire_encode(x, comm), comm,
                                         x.dtype))
        hops = (_IDENTITY_HOP,)
    return Flight(_fly(x, tuple(hops), comm, bwd_hops, bwd_post))


def _completed(v, tag=None):
    return _comm.Handle.completed(v)


_IDENTITY_HOP = (_completed, _completed)


def wire_raw_ok(comm) -> bool:
    """True when the wire format is a plain dtype view (f32 or bf16): the
    payload can stay encoded across a fused kernel boundary.  fp8's scale
    tail changes the M dim, so it always decodes at the collective."""
    return _active(comm) in ("f32", "bf16")


def wire_roundtrip(x, comm=None):
    """Encode then decode with no movement: the stand-in for a wire-format
    collective on a single-member group."""
    return _flight(x, (), comm).wait()


# --- the bound mesh ---------------------------------------------------------

_MESH = None   # the Mesh bound by ``bound`` (apply_moe's shard boundary)


@contextlib.contextmanager
def bound(mesh):
    """Bind ``mesh`` for the collectives called inside, as shard_map binds
    its mesh axes (``None`` binds nothing: one rank)."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def current_mesh():
    """The mesh bound by :func:`bound`, or None."""
    return _MESH


def _axes(axes):
    """Normalize an axis spec (name or iterable of names) to a tuple."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _combined(ep_axes, esp_axes):
    """The combined group's axis tuple, EP-major (JAX's ``names``)."""
    ep, esp = _axes(ep_axes), _axes(esp_axes)
    return ep + tuple(a for a in esp if a not in ep)


def group(axes, n: int, what: str):
    """This rank's :class:`~repro_torch.parallel.mesh.AxisGroup` over
    ``axes`` in the bound mesh, or None for a one-member group (``n ==
    1``).  A larger group with no mesh bound raises."""
    if n == 1:
        return None
    if _MESH is None:
        raise RuntimeError(f"{what} over a group of {n} ranks needs a "
                           "multi-rank mesh bound (collectives.bound, or "
                           "apply_moe(..., mesh=, dims=))")
    g = _MESH.group(_axes(axes))
    if g.size != n:
        raise ValueError(f"{what}: the mesh's group over {g.axes} has "
                         f"{g.size} ranks, the caller says {n}")
    return g


def axis_index(axes) -> int:
    """JAX's ``lax.axis_index(axes)`` in the bound mesh (0 with none)."""
    axes = _axes(axes)
    if _MESH is None or not axes:
        return 0
    return _MESH.axis_index(axes)


def _a2a_hop(grp, split_axis, concat_axis):
    """An AlltoAll hop (its transpose swaps split and concat)."""
    def start(v, tag=None):
        return _comm.all_to_all_start(v, grp, split_axis, concat_axis,
                                      tag=tag)

    def transpose(v, tag=None):
        return _comm.all_to_all_start(v, grp, concat_axis, split_axis,
                                      tag=tag)
    return start, transpose


def _gather_hop(grp, axis, tiled):
    """An AllGather hop (its transpose the reduce-scatter)."""
    def start(v, tag=None):
        return _comm.all_gather_start(v, grp, axis, tiled, tag=tag)

    def transpose(v, tag=None):
        return _comm.psum_scatter_start(v, grp, axis, tiled, tag=tag)
    return start, transpose


# --- PauseMP primitives ------------------------------------------------------

def mp_split(x, mp_axes, n_mp: int, axis: int = 0):
    """MP-Split: this rank's 1/N_MP slice along ``axis`` (the identity at
    ``n_mp == 1``).  The forward is a slice; its backward (JAX's
    transpose of the slice) pads the cotangent with zeros, and the
    AllGather the paper names happens at the shard boundary
    (``apply_moe``'s input cotangent sum over MP)."""
    grp = group(mp_axes, n_mp, f"mp_split over {mp_axes}")
    if grp is None:
        return x
    size = x.shape[axis] // n_mp
    return x.narrow(axis, grp.index * size, size)


def mp_all_gather_start(x, mp_axes, n_mp: int, axis: int = 0) -> Flight:
    """Start :func:`mp_all_gather`."""
    grp = group(mp_axes, n_mp, f"mp_all_gather over {mp_axes}")
    if grp is None:
        return Flight.of(x)
    return _flight(x, (_gather_hop(grp, axis, True),))


def mp_all_gather(x, mp_axes, n_mp: int, axis: int = 0):
    """MP-AllGather, the transpose of :func:`mp_split` (a tiled AllGather;
    backward the reduce-scatter)."""
    return mp_all_gather_start(x, mp_axes, n_mp, axis).wait()


def psum(x, axes, n: int):
    """The AllReduce (the baseline's ESP partial sums, the decode
    fallback's output); its backward is ``psum`` of the cotangent.
    Synchronous: ``comm.psum`` runs in the chain's first node."""
    grp = group(axes, n, f"psum over {axes}")
    if grp is None:
        return x

    def move(v, tag=None):
        return _comm.Handle.completed(_comm.psum(v, grp))
    return _flight(x, ((move, move),)).wait()


def pmean(x, axes, n: int):
    """``psum(x) / n``, as ``lax.pmean`` computes it."""
    if n == 1:
        return x
    return psum(x, axes, n) / n


# --- EP&ESP-AlltoAll ---------------------------------------------------------

def dump(d, n_ep: int, n_esp: int):
    """Local Dump: (E, c, M) -> (G, El, c, M), each expert's tokens once
    per ESP shard, G EP-major / ESP-minor."""
    E, c, M = d.shape
    El = E // n_ep
    out = d.reshape(n_ep, 1, El, c, M).expand(n_ep, n_esp, El, c, M)
    return out.reshape(n_ep * n_esp, El, c, M)


def undump_reduce(r, n_ep: int, n_esp: int):
    """Local Combine: (G, El, c, M) partials -> (E, c, M), summing the
    N_ESP shards."""
    G, El, c, M = r.shape
    r = r.reshape(n_ep, n_esp, El, c, M).sum(dim=1)
    return r.reshape(n_ep * El, c, M)


def to_expert_batch(rb):
    """(G, El, c, M) received buffer -> (El, G*c, M) token batch."""
    G, El, c, M = rb.shape
    return rb.transpose(0, 1).reshape(El, G * c, M)


def from_expert_batch(h, G: int):
    """(El, G*c, M) -> (G, El, c, M), the inverse of
    :func:`to_expert_batch`."""
    El, Gc, M = h.shape
    return h.reshape(El, G, Gc // G, M).transpose(0, 1)


def _a2a_hops(axes, n, what, split_axis, concat_axis):
    grp = group(axes, n, what)
    return () if grp is None else (_a2a_hop(grp, split_axis, concat_axis),)


def ep_esp_all_to_all_start(x, ep_axes, esp_axes, n_group: int, *,
                            split_axis=0, concat_axis=0) -> Flight:
    """Start :func:`ep_esp_all_to_all`."""
    return _flight(x, _a2a_hops(
        _combined(ep_axes, esp_axes), n_group,
        f"the EP&ESP-AlltoAll over {ep_axes} x {esp_axes}", split_axis,
        concat_axis))


def ep_esp_all_to_all(x, ep_axes, esp_axes, n_group: int, *, split_axis=0,
                      concat_axis=0):
    """One fused AlltoAll over the combined (EP, ESP) group of
    ``n_group`` ranks (JAX's tiled ``lax.all_to_all`` over the tuple)."""
    return ep_esp_all_to_all_start(x, ep_axes, esp_axes, n_group,
                                   split_axis=split_axis,
                                   concat_axis=concat_axis).wait()


def ep_all_to_all(x, ep_axes, n_ep: int, *, split_axis=0, concat_axis=0):
    """Plain EP-AlltoAll over the EP axes (baseline schedule)."""
    return _flight(x, _a2a_hops(ep_axes, n_ep,
                                f"the EP-AlltoAll over {ep_axes}",
                                split_axis, concat_axis)).wait()


def _hier_hops(ep_axes, esp_axes, n_ep, n_esp, axis, order):
    """The two hops of the hierarchical AlltoAll over the combined dim at
    ``axis``, viewed as (n_ep, n_esp): the ESP hop over ``axis + 1`` and
    the EP hop over ``axis``, in ``order`` (a one-member group's hop is
    left out).  The two act on different dims, so they commute: the
    backward's reverse order moves the same bits."""
    if order not in ("esp_first", "ep_first"):
        raise ValueError(f"unknown hier order {order!r}")
    ge = group(ep_axes, n_ep, f"the hierarchical EP hop over {ep_axes}")
    gs = group(esp_axes, n_esp,
               f"the hierarchical ESP hop over {esp_axes}")

    def hop(grp, dim):
        def start(v, tag=None):
            shp = v.shape
            v5 = v.reshape(*shp[:axis], n_ep, n_esp, *shp[axis + 1:])
            return _comm.all_to_all_start(v5, grp, dim, dim, tag=tag).then(
                lambda r: r.reshape(shp))
        return start, start

    hops = [(gs, axis + 1), (ge, axis)]
    if order == "ep_first":
        hops.reverse()
    return tuple(hop(g, d) for g, d in hops if g is not None)


def hier_ep_esp_all_to_all(x, ep_axes, esp_axes, n_ep: int, n_esp: int, *,
                           axis=1, order: str = "esp_first"):
    """Hierarchical EP&ESP-AlltoAll: an ESP hop and an EP hop, in either
    ``order`` (the s2h schedule); bitwise the fused AlltoAll."""
    return _flight(x, _hier_hops(ep_axes, esp_axes, n_ep, n_esp, axis,
                                 order)).wait()


# --- wire-format collective entry points -------------------------------------
# Each ``*_start`` returns the :class:`Flight` of its collective; the plain
# form waits on it at once.

def wire_ep_esp_all_to_all_start(x, ep_axes, esp_axes, n_group: int,
                                 comm=None, *, split_axis=0,
                                 concat_axis=0) -> Flight:
    """Start :func:`wire_ep_esp_all_to_all`."""
    assert split_axis == concat_axis, "wire a2a must be self-transposing"
    return _flight(x, _a2a_hops(
        _combined(ep_axes, esp_axes), n_group,
        f"the EP&ESP-AlltoAll over {ep_axes} x {esp_axes}", split_axis,
        concat_axis), comm)


def wire_ep_esp_all_to_all(x, ep_axes, esp_axes, n_group: int, comm=None, *,
                           split_axis=0, concat_axis=0):
    """:func:`ep_esp_all_to_all` with the payload in ``comm``'s wire dtype
    (backward AlltoAll in the same dtype)."""
    return wire_ep_esp_all_to_all_start(
        x, ep_axes, esp_axes, n_group, comm, split_axis=split_axis,
        concat_axis=concat_axis).wait()


def wire_ep_all_to_all_start(x, ep_axes, n_ep: int, comm=None, *,
                             split_axis=0, concat_axis=0) -> Flight:
    """Start :func:`wire_ep_all_to_all`."""
    assert split_axis == concat_axis, "wire a2a must be self-transposing"
    return _flight(x, _a2a_hops(ep_axes, n_ep,
                                f"the EP-AlltoAll over {ep_axes}",
                                split_axis, concat_axis), comm)


def wire_ep_all_to_all(x, ep_axes, n_ep: int, comm=None, *, split_axis=0,
                       concat_axis=0):
    """:func:`ep_all_to_all` in the wire format (baseline schedule)."""
    return wire_ep_all_to_all_start(x, ep_axes, n_ep, comm,
                                    split_axis=split_axis,
                                    concat_axis=concat_axis).wait()


def wire_hier_ep_esp_all_to_all_start(x, ep_axes, esp_axes, n_ep: int,
                                      n_esp: int, comm=None, *, axis=1,
                                      order: str = "esp_first") -> Flight:
    """Start :func:`wire_hier_ep_esp_all_to_all`: its first hop now, the
    second once a wait finds the first landed (the flight's two steps)."""
    return _flight(x, _hier_hops(ep_axes, esp_axes, n_ep, n_esp, axis,
                                 order), comm)


def wire_hier_ep_esp_all_to_all(x, ep_axes, esp_axes, n_ep: int,
                                n_esp: int, comm=None, *, axis=1,
                                order: str = "esp_first"):
    """:func:`hier_ep_esp_all_to_all` in the wire format: one encode
    before the first hop, one decode after the second, so both hops ship
    the encoded payload."""
    return wire_hier_ep_esp_all_to_all_start(
        x, ep_axes, esp_axes, n_ep, n_esp, comm, axis=axis,
        order=order).wait()


def wire_mp_all_gather_start(x, mp_axes, n_mp: int, comm=None,
                             axis: int = 0) -> Flight:
    """Start :func:`wire_mp_all_gather`."""
    grp = group(mp_axes, n_mp, f"mp_all_gather over {mp_axes}")
    if grp is None:
        return Flight.of(x)

    def bwd_post(g):
        s = g.shape
        return g.reshape(*s[:axis], n_mp, s[axis] // n_mp,
                         *s[axis + 1:]).sum(dim=axis)

    return _flight(x, (_gather_hop(grp, axis, True),), comm,
                   bwd_hops=(_a2a_hop(grp, axis, axis),), bwd_post=bwd_post)


def wire_mp_all_gather(x, mp_axes, n_mp: int, comm=None, axis: int = 0):
    """:func:`mp_all_gather` in the wire format; at ``n_mp == 1`` it
    returns ``x`` untouched, no codec, as the JAX function does.  Its
    transpose is the reduce-scatter; the fp8 backward is an AlltoAll over
    the gathered dim followed by a sum after the decode."""
    return wire_mp_all_gather_start(x, mp_axes, n_mp, comm, axis).wait()


def wire_all_gather_stacked_start(x, mp_axes, n_mp: int, comm=None,
                                  axis: int = 1) -> Flight:
    """Start :func:`wire_all_gather_stacked`."""
    grp = group(mp_axes, n_mp, f"the stacked AllGather over {mp_axes}")
    if grp is None:
        return _flight(x, (), comm).then(lambda v: v.unsqueeze(axis))
    return _flight(x, (_gather_hop(grp, axis, False),), comm,
                   bwd_hops=(_a2a_hop(grp, axis, axis),),
                   bwd_post=lambda g: g.sum(dim=axis))


def wire_all_gather_stacked(x, mp_axes, n_mp: int, comm=None,
                            axis: int = 1):
    """Untiled (stacking) AllGather in the wire format: a new group dim
    at ``axis`` (the SAA / ``s2_pipe`` per-chunk MP-AllGather).  The codec
    runs at size 1, as in JAX; the fp8 backward is an AlltoAll over the
    group dim, the decode and a sum."""
    return wire_all_gather_stacked_start(x, mp_axes, n_mp, comm,
                                         axis).wait()


# --- expert-major buffer layout ----------------------------------------------

def dump_em(d, n_ep: int, n_esp: int):
    """Dump in expert-major layout: (E, c, M) -> (El, G, c, M)."""
    E, c, M = d.shape
    El = E // n_ep
    out = d.reshape(n_ep, El, c, M).transpose(0, 1)          # (El, Ne, c, M)
    out = out[:, :, None].expand(El, n_ep, n_esp, c, M)
    return out.reshape(El, n_ep * n_esp, c, M)


def undump_reduce_em(r, n_ep: int, n_esp: int):
    """(El, G, c, M) partials -> (E, c, M), summing the ESP shards."""
    El, G, c, M = r.shape
    r = r.reshape(El, n_ep, n_esp, c, M).sum(dim=2)          # (El, Ne, c, M)
    return r.transpose(0, 1).reshape(n_ep * El, c, M)


def to_expert_batch_em(rb):
    """(El, G, c, M) -> (El, G*c, M)."""
    El, G, c, M = rb.shape
    return rb.reshape(El, G * c, M)


def from_expert_batch_em(h, G: int):
    """(El, G*c, M) -> (El, G, c, M)."""
    El, Gc, M = h.shape
    return h.reshape(El, G, Gc // G, M)


# --- SAA: simultaneous AlltoAll + AllGather (S2 combine path) ---------------

def saa_combine_allgather_start(y, ep_axes, esp_axes, mp_axes, *, n_ep: int,
                                n_esp: int, n_mp: int, n_chunks: int = 4,
                                comm: CommConfig | None = None,
                                overlap: bool = True) -> Flight:
    """Start :func:`saa_combine_allgather`: chunk 0's and chunk 1's
    AlltoAlls now; each wait on chunk i's AlltoAll comes after chunk
    i+1's start, and chunk i's stacked MP-AllGather starts as soon as
    chunk i has landed and been reduced, so it is in flight beside chunk
    i+1's AlltoAll (paper Fig. 5).  ``overlap=False`` waits on each
    collective as soon as it starts (the serial twin: the same bits).
    The collectives are tagged ``<tag>#<chunk>``."""
    return Flight(_saa(y, ep_axes, esp_axes, mp_axes, n_ep, n_esp, n_mp,
                       n_chunks, comm, overlap))


def _saa(y, ep_axes, esp_axes, mp_axes, n_ep, n_esp, n_mp, n_chunks, comm,
         overlap):
    El, G, c, M = y.shape
    n_chunks = max(1, min(n_chunks, c))
    while c % n_chunks:
        n_chunks -= 1
    cs = c // n_chunks
    E = n_ep * El
    tag = _comm.current_tag()

    def chunk_tag(i):
        return f"{tag}#{i}" if tag is not None else None

    def a2a(i):
        with _comm.tagged(chunk_tag(i)):
            f = wire_ep_esp_all_to_all_start(
                y.narrow(2, i * cs, cs), ep_axes, esp_axes, n_ep * n_esp,
                comm, split_axis=1, concat_axis=1)
        if not overlap:
            f.wait()
        return f

    def gather(i, comb):
        if n_mp == 1:
            return Flight.of(comb[:, None])              # (E, 1, cs, M)
        with _comm.tagged(chunk_tag(i)):
            f = wire_all_gather_stacked_start(comb, mp_axes, n_mp, comm,
                                              axis=1)
        if not overlap:
            f.wait()
        return f

    moving, parts = [a2a(0)], []
    for i in range(n_chunks):
        if i + 1 < n_chunks and overlap:
            moving.append(a2a(i + 1))
        yield moving[i]
        comb = undump_reduce_em(moving[i].wait(), n_ep, n_esp)   # (E, cs, M)
        parts.append(gather(i, comb))
        if i + 1 < n_chunks and not overlap:
            moving.append(a2a(i + 1))
    yield parts[-1]
    stacked = torch.stack([p.wait() for p in parts], dim=2)
    return stacked.reshape(E, n_mp * c, M)   # (E, N_MP, n_chunks, cs, M)


def saa_combine_allgather(y, ep_axes, esp_axes, mp_axes, *, n_ep: int,
                          n_esp: int, n_mp: int, n_chunks: int = 4,
                          comm: CommConfig | None = None):
    """Chunked combine EP&ESP-AlltoAll + MP-AllGather.  y: (El, G, c, M)
    -> (E, c * N_MP, M), slot-ordered (mp_rank, slot).  Each chunk's
    AlltoAll runs the wire codec, as in JAX; the chunks' collectives are
    in flight together (:func:`saa_combine_allgather_start`)."""
    return saa_combine_allgather_start(
        y, ep_axes, esp_axes, mp_axes, n_ep=n_ep, n_esp=n_esp, n_mp=n_mp,
        n_chunks=n_chunks, comm=comm).wait()
