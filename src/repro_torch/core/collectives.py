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


class _Fp8Moved(torch.autograd.Function):
    """fp8 wire move with JAX's ``custom_vjp``: the backward re-encodes
    the cotangent with its own absmax scales, moves it through
    ``bwd_move``, decodes it and applies ``bwd_post``."""

    @staticmethod
    def forward(ctx, x, comm, move, bwd_move, bwd_post):
        ctx.comm, ctx.dtype = comm, x.dtype
        ctx.bwd_move, ctx.bwd_post = bwd_move or move, bwd_post
        ctx.tags = obs.trace_context() if obs.enabled() else None
        return wire_decode(move(wire_encode(x, comm)), comm, x.dtype)

    @staticmethod
    def backward(ctx, g):
        with (obs.trace_tag(**ctx.tags) if ctx.tags
              else contextlib.nullcontext()):
            enc = wire_encode(g, ctx.comm)
        gd = wire_decode(ctx.bwd_move(enc), ctx.comm, ctx.dtype)
        if ctx.bwd_post is not None:
            gd = ctx.bwd_post(gd)
        return gd, None, None, None, None


class _Moved(torch.autograd.Function):
    """A bit-moving collective ``move`` whose backward is the collective
    ``transpose`` (both raw ``parallel.comm`` calls bound to a group)."""

    @staticmethod
    def forward(ctx, x, move, transpose):
        ctx.transpose = transpose
        return move(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.transpose(g.contiguous()), None, None


def _wire_moved(x, move, comm, *, transpose=None, bwd_move=None,
                bwd_post=None):
    """Run a bit-moving collective ``move`` in the wire format, with the
    backward collective in the same wire dtype: f32 runs ``move`` raw,
    bf16 composes casts around it (autograd transposes them), each with
    ``transpose`` (default ``move``: the self-transposing AlltoAlls) as
    the move's backward; fp8 goes through :class:`_Fp8Moved`, whose
    backward moves the re-encoded cotangent through ``bwd_move`` and then
    applies ``bwd_post`` (the local sum a gather's transpose needs).
    ``move is _identity`` (a one-member group) runs the codec alone."""
    wd = _active(comm)
    if wd in ("f32", "bf16"):
        enc = wire_encode(x, comm)
        moved = enc if move is _identity else _Moved.apply(
            enc, move, transpose or move)
        return wire_decode(moved, comm, x.dtype)
    return _Fp8Moved.apply(x, comm, move, bwd_move, bwd_post)


def wire_raw_ok(comm) -> bool:
    """True when the wire format is a plain dtype view (f32 or bf16): the
    payload can stay encoded across a fused kernel boundary.  fp8's scale
    tail changes the M dim, so it always decodes at the collective."""
    return _active(comm) in ("f32", "bf16")


def wire_roundtrip(x, comm=None):
    """Encode then decode with no movement: the stand-in for a wire-format
    collective on a single-member group."""
    return _wire_moved(x, _identity, comm)


def _identity(v):
    return v


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


def _a2a(grp, split_axis, concat_axis):
    def move(v):
        return _comm.all_to_all(v, grp, split_axis, concat_axis)
    return move


def _moved_a2a(x, grp, split_axis, concat_axis):
    """Differentiable AlltoAll (its backward swaps split and concat)."""
    return _Moved.apply(x, _a2a(grp, split_axis, concat_axis),
                        _a2a(grp, concat_axis, split_axis))


def _gather(grp, axis, tiled):
    def move(v):
        return _comm.all_gather(v, grp, axis, tiled)

    def transpose(g):
        return _comm.psum_scatter(g, grp, axis, tiled)
    return move, transpose


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


def mp_all_gather(x, mp_axes, n_mp: int, axis: int = 0):
    """MP-AllGather, the transpose of :func:`mp_split` (a tiled AllGather;
    backward the reduce-scatter)."""
    grp = group(mp_axes, n_mp, f"mp_all_gather over {mp_axes}")
    if grp is None:
        return x
    move, transpose = _gather(grp, axis, True)
    return _Moved.apply(x, move, transpose)


def psum(x, axes, n: int):
    """The AllReduce (the baseline's ESP partial sums, the decode
    fallback's output); its backward is ``psum`` of the cotangent."""
    grp = group(axes, n, f"psum over {axes}")
    if grp is None:
        return x

    def move(v):
        return _comm.psum(v, grp)
    return _Moved.apply(x, move, move)


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


def ep_esp_all_to_all(x, ep_axes, esp_axes, n_group: int, *, split_axis=0,
                      concat_axis=0):
    """One fused AlltoAll over the combined (EP, ESP) group of
    ``n_group`` ranks (JAX's tiled ``lax.all_to_all`` over the tuple)."""
    grp = group(_combined(ep_axes, esp_axes), n_group,
                f"the EP&ESP-AlltoAll over {ep_axes} x {esp_axes}")
    if grp is None:
        return x
    return _moved_a2a(x, grp, split_axis, concat_axis)


def ep_all_to_all(x, ep_axes, n_ep: int, *, split_axis=0, concat_axis=0):
    """Plain EP-AlltoAll over the EP axes (baseline schedule)."""
    grp = group(ep_axes, n_ep, f"the EP-AlltoAll over {ep_axes}")
    if grp is None:
        return x
    return _moved_a2a(x, grp, split_axis, concat_axis)


def _hier_groups(ep_axes, esp_axes, n_ep, n_esp, order):
    if order not in ("esp_first", "ep_first"):
        raise ValueError(f"unknown hier order {order!r}")
    return (group(ep_axes, n_ep, f"the hierarchical EP hop over {ep_axes}"),
            group(esp_axes, n_esp,
                  f"the hierarchical ESP hop over {esp_axes}"))


def _hier_move(x, ge, gs, n_ep, n_esp, axis, order, hop):
    """The two hops of the hierarchical AlltoAll over the combined dim at
    ``axis``, viewed as (n_ep, n_esp), over the EP group ``ge`` and the
    ESP group ``gs``; ``hop(v, grp, dim)`` moves one."""
    if ge is None and gs is None:
        return x
    shp = x.shape
    x5 = x.reshape(*shp[:axis], n_ep, n_esp, *shp[axis + 1:])
    hops = [(gs, axis + 1), (ge, axis)]
    if order == "ep_first":
        hops.reverse()
    for grp, dim in hops:
        if grp is not None:
            x5 = hop(x5, grp, dim)
    return x5.reshape(shp)


def hier_ep_esp_all_to_all(x, ep_axes, esp_axes, n_ep: int, n_esp: int, *,
                           axis=1, order: str = "esp_first"):
    """Hierarchical EP&ESP-AlltoAll: an ESP hop and an EP hop, in either
    ``order`` (the s2h schedule); bitwise the fused AlltoAll."""
    ge, gs = _hier_groups(ep_axes, esp_axes, n_ep, n_esp, order)
    return _hier_move(x, ge, gs, n_ep, n_esp, axis, order,
                      lambda v, grp, dim: _moved_a2a(v, grp, dim, dim))


# --- wire-format collective entry points -------------------------------------

def wire_ep_esp_all_to_all(x, ep_axes, esp_axes, n_group: int, comm=None, *,
                           split_axis=0, concat_axis=0):
    """:func:`ep_esp_all_to_all` with the payload in ``comm``'s wire dtype
    (backward AlltoAll in the same dtype)."""
    assert split_axis == concat_axis, "wire a2a must be self-transposing"
    grp = group(_combined(ep_axes, esp_axes), n_group,
                f"the EP&ESP-AlltoAll over {ep_axes} x {esp_axes}")
    move = _identity if grp is None else _a2a(grp, split_axis, concat_axis)
    return _wire_moved(x, move, comm)


def wire_ep_all_to_all(x, ep_axes, n_ep: int, comm=None, *, split_axis=0,
                       concat_axis=0):
    """:func:`ep_all_to_all` in the wire format (baseline schedule)."""
    assert split_axis == concat_axis, "wire a2a must be self-transposing"
    grp = group(ep_axes, n_ep, f"the EP-AlltoAll over {ep_axes}")
    move = _identity if grp is None else _a2a(grp, split_axis, concat_axis)
    return _wire_moved(x, move, comm)


def wire_hier_ep_esp_all_to_all(x, ep_axes, esp_axes, n_ep: int,
                                n_esp: int, comm=None, *, axis=1,
                                order: str = "esp_first"):
    """:func:`hier_ep_esp_all_to_all` in the wire format: one encode
    before the first hop, one decode after the second, so both hops ship
    the encoded payload; the two-hop move is its own transpose."""
    ge, gs = _hier_groups(ep_axes, esp_axes, n_ep, n_esp, order)

    def move(w):
        return _hier_move(w, ge, gs, n_ep, n_esp, axis, order,
                          lambda v, grp, dim: _comm.all_to_all(v, grp, dim,
                                                               dim))
    if ge is None and gs is None:
        move = _identity
    return _wire_moved(x, move, comm)


def wire_mp_all_gather(x, mp_axes, n_mp: int, comm=None, axis: int = 0):
    """:func:`mp_all_gather` in the wire format; at ``n_mp == 1`` it
    returns ``x`` untouched, no codec, as the JAX function does.  Its
    transpose is the reduce-scatter; the fp8 backward is an AlltoAll over
    the gathered dim followed by a sum after the decode."""
    grp = group(mp_axes, n_mp, f"mp_all_gather over {mp_axes}")
    if grp is None:
        return x
    move, transpose = _gather(grp, axis, True)

    def bwd_post(g):
        s = g.shape
        return g.reshape(*s[:axis], n_mp, s[axis] // n_mp,
                         *s[axis + 1:]).sum(dim=axis)

    return _wire_moved(x, move, comm, transpose=transpose,
                       bwd_move=_a2a(grp, axis, axis), bwd_post=bwd_post)


def wire_all_gather_stacked(x, mp_axes, n_mp: int, comm=None,
                            axis: int = 1):
    """Untiled (stacking) AllGather in the wire format: a new group dim
    at ``axis`` (the SAA / ``s2_pipe`` per-chunk MP-AllGather).  The codec
    runs at size 1, as in JAX; the fp8 backward is an AlltoAll over the
    group dim, the decode and a sum."""
    grp = group(mp_axes, n_mp, f"the stacked AllGather over {mp_axes}")
    if grp is None:
        return _wire_moved(x, _identity, comm).unsqueeze(axis)
    move, transpose = _gather(grp, axis, False)
    return _wire_moved(x, move, comm, transpose=transpose,
                       bwd_move=_a2a(grp, axis, axis),
                       bwd_post=lambda g: g.sum(dim=axis))


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

def saa_combine_allgather(y, ep_axes, esp_axes, mp_axes, *, n_ep: int,
                          n_esp: int, n_mp: int, n_chunks: int = 4,
                          comm: CommConfig | None = None):
    """Chunked combine EP&ESP-AlltoAll + MP-AllGather.  y: (El, G, c, M)
    -> (E, c * N_MP, M), slot-ordered (mp_rank, slot).  Each chunk's
    AlltoAll runs the wire codec, as in JAX."""
    El, G, c, M = y.shape
    n_chunks = max(1, min(n_chunks, c))
    while c % n_chunks:
        n_chunks -= 1
    cs = c // n_chunks
    E = n_ep * El
    parts = []
    for i in range(n_chunks):
        chunk = y.narrow(2, i * cs, cs)
        back = wire_ep_esp_all_to_all(chunk, ep_axes, esp_axes, n_ep * n_esp,
                                      comm, split_axis=1, concat_axis=1)
        comb = undump_reduce_em(back, n_ep, n_esp)            # (E, cs, M)
        if n_mp == 1:
            parts.append(comb[:, None])                       # (E, 1, cs, M)
        else:
            parts.append(wire_all_gather_stacked(comb, mp_axes, n_mp, comm,
                                                 axis=1))
    stacked = torch.stack(parts, dim=2)          # (E, N_MP, n_chunks, cs, M)
    return stacked.reshape(E, n_mp * c, M)
