"""Parm's communication primitives on one rank (counterpart of
``repro/core/collectives.py``).

The JAX package issues its collectives as ``jax.lax`` ops inside a
shard_map body; this slice of the port runs on one rank, where every group
(EP, ESP, MP and their combinations) has one member.  Every collective here
is then the identity, as a ``lax`` collective over a size-1 axis is, and on
a larger group it raises ``NotImplementedError``: the collectives on
``torch.distributed`` come with the multi-rank slice.  Where the JAX
function reads its group size from the mesh, the port's takes it as an
argument.

The wire codec still runs at group size 1, as in JAX: a ``wire_*``
collective encodes its payload (f32 identity, bf16 cast, fp8_e4m3 with a
per-row absmax scale bitcast into a 4-byte tail), moves it (the identity)
and decodes it, forward and backward.  It is plain PyTorch: the codec is
jnp in the JAX package, not a TPU kernel.

The fp8 saturation monitor and fault injection of the JAX module
(``set_fp8_monitor``, ``set_fp8_sat_injection``) hook the fp8 encode at
the JAX module's points; the guard rails (``runtime/guards.py``) install
the monitor.  The fp8 move's backward re-encodes its cotangent under the
call context of its forward (``obs.trace_tag``), so a saturation event of
the backward says which MoE call it belongs to, as the forward's does.  The layout helpers (``dump``, ``undump_reduce``,
``to/from_expert_batch`` and the expert-major ``*_em`` twins) are the JAX
module's reshapes, written for torch tensors.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from repro_torch import obs

#: the wire formats (``repro/core/perfmodel.py``'s constant, copied)
WIRE_DTYPES = ("f32", "bf16", "fp8_e4m3")

MULTI_RANK = ("comes with the multi-rank slice of the port "
              "(collectives on torch.distributed); this slice runs one rank")


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


def _single(n: int, what: str) -> None:
    if n != 1:
        raise NotImplementedError(f"{what} over a group of {n} ranks "
                                  f"{MULTI_RANK}")


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


def _wire_moved(x, move, comm, *, bwd_move=None, bwd_post=None):
    """Run a bit-moving collective ``move`` in the wire format, with the
    backward collective in the same wire dtype: f32 runs ``move`` raw,
    bf16 composes casts (autograd transposes them), fp8 goes through
    :class:`_Fp8Moved`."""
    wd = _active(comm)
    if wd in ("f32", "bf16"):
        return wire_decode(move(wire_encode(x, comm)), comm, x.dtype)
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


# --- PauseMP primitives ------------------------------------------------------

def mp_split(x, mp_axes, n_mp: int, axis: int = 0):
    """MP-Split: this rank's 1/N_MP slice along ``axis`` (the identity at
    ``n_mp == 1``)."""
    _single(n_mp, f"mp_split over {mp_axes}")
    return x


def mp_all_gather(x, mp_axes, n_mp: int, axis: int = 0):
    """MP-AllGather, the transpose of :func:`mp_split`."""
    _single(n_mp, f"mp_all_gather over {mp_axes}")
    return x


def psum(x, axes, n: int):
    """The in-network AllReduce (the baseline's ESP partial sums)."""
    _single(n, f"psum over {axes}")
    return x


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
    ``n_group`` ranks."""
    _single(n_group, f"the EP&ESP-AlltoAll over {ep_axes} x {esp_axes}")
    return x


def ep_all_to_all(x, ep_axes, n_ep: int, *, split_axis=0, concat_axis=0):
    """Plain EP-AlltoAll over the EP axes (baseline schedule)."""
    _single(n_ep, f"the EP-AlltoAll over {ep_axes}")
    return x


def hier_ep_esp_all_to_all(x, ep_axes, esp_axes, n_ep: int, n_esp: int, *,
                           axis=1, order: str = "esp_first"):
    """Hierarchical EP&ESP-AlltoAll: an ESP hop and an EP hop, in either
    ``order`` (the s2h schedule); bitwise the fused AlltoAll."""
    if order not in ("esp_first", "ep_first"):
        raise ValueError(f"unknown hier order {order!r}")
    _single(n_ep * n_esp, f"the hierarchical AlltoAll over {ep_axes} x "
            f"{esp_axes}")
    return x


# --- wire-format collective entry points -------------------------------------

def wire_ep_esp_all_to_all(x, ep_axes, esp_axes, n_group: int, comm=None, *,
                           split_axis=0, concat_axis=0):
    """:func:`ep_esp_all_to_all` with the payload in ``comm``'s wire dtype
    (backward AlltoAll in the same dtype)."""
    assert split_axis == concat_axis, "wire a2a must be self-transposing"
    _single(n_group, f"the EP&ESP-AlltoAll over {ep_axes} x {esp_axes}")
    return _wire_moved(x, _identity, comm)


def wire_ep_all_to_all(x, ep_axes, n_ep: int, comm=None, *, split_axis=0,
                       concat_axis=0):
    """:func:`ep_all_to_all` in the wire format (baseline schedule)."""
    assert split_axis == concat_axis, "wire a2a must be self-transposing"
    _single(n_ep, f"the EP-AlltoAll over {ep_axes}")
    return _wire_moved(x, _identity, comm)


def wire_hier_ep_esp_all_to_all(x, ep_axes, esp_axes, n_ep: int,
                                n_esp: int, comm=None, *, axis=1,
                                order: str = "esp_first"):
    """:func:`hier_ep_esp_all_to_all` in the wire format: one encode
    before the first hop, one decode after the second."""
    hier_ep_esp_all_to_all(x, ep_axes, esp_axes, n_ep, n_esp, axis=axis,
                           order=order)
    return _wire_moved(x, _identity, comm)


def wire_mp_all_gather(x, mp_axes, n_mp: int, comm=None, axis: int = 0):
    """:func:`mp_all_gather` in the wire format; at ``n_mp == 1`` it
    returns ``x`` untouched, no codec, as the JAX function does."""
    _single(n_mp, f"mp_all_gather over {mp_axes}")
    return x


def wire_all_gather_stacked(x, mp_axes, n_mp: int, comm=None,
                            axis: int = 1):
    """Untiled (stacking) AllGather in the wire format: a new group dim
    at ``axis``.  The codec runs at size 1, as in JAX."""
    _single(n_mp, f"the stacked AllGather over {mp_axes}")
    return _wire_moved(x, _identity, comm).unsqueeze(axis)


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
