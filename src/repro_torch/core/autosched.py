"""The ``schedule="auto"`` runtime: per-layer (schedule, chunks, wire)
decisions (counterpart of ``repro/core/autosched.py``).

Parm's Algorithm 1 picks S1 or S2 from the alpha-beta model; the
pipelined bodies (``repro_torch.core.pipeline``) add a second axis — how
many micro-chunks to split the AlltoAll/FFN chain into — and the wire
format (``repro_torch.core.collectives.CommConfig``) a third: how many
bytes each element of those collectives puts on the fabric.  This module
owns the joint decision:

  * **analytic** mode enumerates the schedule axis from the *plan
    registry* (``repro_torch.core.plan.PLANS``) and scores every
    (schedule, n_chunks) candidate by walking its plan graph with
    :meth:`repro_torch.core.perfmodel.PerfModel.t_plan` — no device
    touched, fully deterministic under a fixed perf model.
  * **measured** mode runs a one-shot calibration on the layer's device:
    each candidate runs ``apply_moe`` on synthetic data of the layer's
    shape, timed by CUDA events (:func:`measure_candidates`), and the
    observed winner is recorded.

Either way the result is a :class:`ScheduleDecision` cached per
``(MoELayerShape, mode, candidates, perf model)`` (measured decisions also
per device) — so a training run decides once per distinct MoE layer
shape, every later ``apply_moe`` call (an activation-checkpointed block's
recompute included) hits the cache, and repeated runs under the same perf
model make identical picks.

``apply_moe`` consults :func:`decide` whenever ``MoEConfig.schedule`` is
``"auto"`` or its wire dtype is ``"auto"``; ``launch/train.py --autosched
measured`` switches modes from the command line.  The process-wide wire
ceiling (:func:`set_wire_ceiling`) is the guard rails' fp8 overflow
fallback.  The placement registry keys decisions by placement epoch as in
JAX; placements themselves (``decide_placement``, ``maybe_rebalance``)
come with the port of ``core/placement.py``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, replace
from typing import Callable, Optional

import torch

from repro_torch import obs
from repro_torch.core import plan as planlib
from repro_torch.core.perfmodel import (MoELayerShape, PerfModel,  # noqa: F401
                                        WIRE_BYTES, h100_model)
from repro_torch.core.pipeline import PIPELINE_OF  # populates the registry

#: The schedule axis of the candidate grid is the *plan registry*
#: (``repro_torch.core.plan.PLANS``): registering a schedule adds it to
#: the analytic and measured grids per its ``PlanEntry`` flags.
#: ``baseline`` is measured-only; ``s1_seqpar`` is in neither grid.
DEFAULT_CHUNKS = (1, 2, 4, 8)
#: wire dtypes scored by default (no compression; the legacy pair grid
#: scores with wire_dtype=None)
DEFAULT_WIRE = ("f32",)
#: candidates when ``CommConfig.wire_dtype == "auto"``.  fp8 is excluded
#: on purpose: the analytic model knows only bytes, so it would always
#: pick the narrowest dtype; fp8's accuracy cost must be opted into
#: explicitly (``wire_dtype="fp8_e4m3"``), never chosen silently.
AUTO_WIRE = ("f32", "bf16")


@dataclass(frozen=True)
class ScheduleDecision:
    """The cached outcome of one auto-scheduling decision.

    ``schedule`` is the base schedule name, ``n_chunks`` the micro-chunk
    count (1 = unchunked), ``wire_dtype`` the collective payload width,
    ``source`` how it was reached (``analytic`` / ``measured``), and
    ``times`` the scored candidates as ``(candidate, seconds)`` pairs
    sorted fastest-first — ``(schedule, n_chunks)`` pairs under the
    default f32-only wire grid and ``(schedule, n_chunks, wire_dtype)``
    triples under a joint wire decision.
    """

    schedule: str
    n_chunks: int = 1
    source: str = "analytic"
    times: tuple = ()
    wire_dtype: str = "f32"
    #: the process-wide placement epoch this decision was made under
    #: (see :func:`set_placement`); ``cache_summary`` marks decisions
    #: from an older epoch as stale.
    placement_epoch: int = 0

    @property
    def body_name(self) -> str:
        """The ``schedules.BODY`` key implementing this decision."""
        if self.n_chunks > 1:
            return PIPELINE_OF.get(self.schedule, self.schedule)
        return self.schedule


_CACHE: dict = {}

#: process-wide wire ceiling: fp8 decisions are clamped up to this dtype
#: when set (see :func:`set_wire_ceiling`) — the guard rails' overflow
#: fallback.  None = no clamping (the default).
_WIRE_CEILING = None

#: callbacks fired by :func:`invalidate` (observability for plan swaps)
_INVALIDATION_HOOKS: list = []

#: process-wide expert placement (None = uniform) and a monotone epoch
#: counter, so cached decisions record which placement regime they were
#: made under.
_PLACEMENT = None
_PLACEMENT_EPOCH = 0


def clear_cache() -> None:
    """Drop every cached decision and reset the placement registry
    (tests, or after remeshing)."""
    global _PLACEMENT, _PLACEMENT_EPOCH
    _CACHE.clear()
    _PLACEMENT = None
    _PLACEMENT_EPOCH = 0


def invalidate(reason: str = "", shape=None) -> int:
    """Decision-cache invalidation hook: drop cached decisions and
    notify registered hooks.  Returns the number of entries dropped.

    With ``shape=None`` (the default) every decision is dropped — the
    "cheap plan swap" entry point: after changing something decisions
    depend on outside the cache key (e.g. the wire ceiling), call this;
    the next ``apply_moe`` call re-consults :func:`decide` (PyTorch runs
    eagerly: nothing to retrace).  Passing a ``MoELayerShape`` drops only
    that shape's decisions (every mode / grid / perf-model variant),
    leaving other layers' lines warm.
    """
    if shape is None:
        n = len(_CACHE)
        _CACHE.clear()
    else:
        drop = [k for k in _CACHE if k[0] == shape]
        for k in drop:
            del _CACHE[k]
        n = len(drop)
    for cb in list(_INVALIDATION_HOOKS):
        cb(reason, n)
    obs.emit("autosched_invalidate", reason=reason, dropped=n)
    return n


def set_placement(placement) -> int:
    """Install ``placement`` (an ``ExpertPlacement`` or None = uniform)
    as the process-wide expert placement and bump the placement epoch.

    The decision cache is deliberately NOT flushed; the epoch is part of
    every new :func:`decide` cache key, so the next decision for a shape
    is made afresh under the new placement while :func:`cache_summary`
    marks the old lines stale.  Returns the new epoch.
    """
    global _PLACEMENT, _PLACEMENT_EPOCH
    _PLACEMENT = placement
    _PLACEMENT_EPOCH += 1
    obs.emit("placement_epoch", epoch=_PLACEMENT_EPOCH,
             uniform=placement is None,
             n_phys=getattr(placement, "n_phys", None),
             cap_frac=getattr(placement, "cap_frac", None))
    return _PLACEMENT_EPOCH


def current_placement():
    """The installed ``ExpertPlacement`` (None = uniform)."""
    return _PLACEMENT


def placement_epoch() -> int:
    return _PLACEMENT_EPOCH


def add_invalidation_hook(cb) -> None:
    """Register ``cb(reason, n_dropped)`` to observe invalidations."""
    _INVALIDATION_HOOKS.append(cb)


def remove_invalidation_hook(cb) -> None:
    if cb in _INVALIDATION_HOOKS:
        _INVALIDATION_HOOKS.remove(cb)


def set_wire_ceiling(wire) -> None:
    """Clamp every *resolved* wire decision to at least ``wire`` bytes
    per element (None clears).  ``apply_moe`` applies the clamp via
    :func:`clamp_wire` after resolving forced/auto wire dtypes, so one
    ``set_wire_ceiling("bf16")`` + :func:`invalidate` swaps every fp8
    wire in the model to bf16 from the next call on — the guard rails'
    fp8 overflow fallback — without touching configs or restarting."""
    global _WIRE_CEILING
    if wire is not None and wire not in WIRE_BYTES:
        raise ValueError(f"unknown wire dtype {wire!r} "
                         f"(want one of {tuple(WIRE_BYTES)})")
    _WIRE_CEILING = wire


def wire_ceiling():
    return _WIRE_CEILING


def clamp_wire(wire: str) -> str:
    """Apply the process-wide wire ceiling to a resolved wire dtype:
    dtypes narrower than the ceiling are widened to it, wider ones pass
    through untouched."""
    if _WIRE_CEILING is None or wire not in WIRE_BYTES:
        return wire
    if WIRE_BYTES[wire] < WIRE_BYTES[_WIRE_CEILING]:
        return _WIRE_CEILING
    return wire


def cache_info() -> dict:
    """Snapshot of the decision cache: key -> ScheduleDecision."""
    return dict(_CACHE)


def cache_summary(exclude=()) -> str:
    """One line per cached decision, for run logs.  ``exclude`` filters
    out keys already present before a run (see ``Trainer``), so multi-
    model processes only report their own decisions."""
    lines = []
    for key, d in sorted(_CACHE.items(), key=lambda kv: repr(kv[0][0])):
        if key in exclude:
            continue
        shape, mode = key[0], key[1]
        cls = " decode" if getattr(shape, "infer", False) else ""
        ep = d.placement_epoch
        stale = " STALE" if ep != _PLACEMENT_EPOCH else ""
        lines.append(
            f"autosched[{mode}{cls}] BxL={shape.B}x{shape.L} M={shape.M} "
            f"E={shape.E} ep/esp/mp={shape.n_ep}/{shape.n_esp}/{shape.n_mp}"
            f" -> {d.schedule} x{d.n_chunks} chunks wire={d.wire_dtype}"
            f" ({d.source} placement-epoch={ep}{stale})")
    return "\n".join(lines)


def _norm(cand):
    """Candidate -> (schedule, n_chunks, wire_dtype), defaulting f32."""
    return cand if len(cand) == 3 else (cand[0], cand[1], "f32")


def decide(shape: MoELayerShape, *, perf_model: Optional[PerfModel] = None,
           mode: str = "analytic", chunk_candidates=DEFAULT_CHUNKS,
           wire_candidates=DEFAULT_WIRE, schedules=None,
           measure: Optional[Callable] = None) -> ScheduleDecision:
    """Pick (schedule, n_chunks, wire_dtype) for one MoE layer shape,
    with caching.

    ``wire_candidates`` widens the grid to a joint comm-precision
    decision (``AUTO_WIRE`` when ``CommConfig.wire_dtype == "auto"``);
    with the default f32-only grid, candidates stay the legacy
    ``(schedule, n_chunks)`` pairs.  ``schedules`` restricts the
    schedule axis (a forced schedule that still wants a wire decision).
    Exact ties break toward the *wider* wire dtype, so compression is
    only picked where the model says the comm term actually shrinks the
    layer time.  ``measure`` (measured mode) maps the candidate list to
    ``{candidate: seconds}``; :func:`measure_candidates` builds one for a
    device.  The decision is cached on every argument (and, in measured
    mode, on ``measure.device``: a CPU calibration never answers for the
    card) — pass the same arguments, get the identical decision back.
    """
    if mode not in ("analytic", "measured"):
        raise ValueError(f"unknown autosched mode {mode!r}")
    pm = perf_model or h100_model(shape.n_ep, shape.n_esp, shape.n_mp)
    wire_candidates = tuple(wire_candidates)
    joint_wire = wire_candidates != ("f32",)
    # Resolve the schedule grid BEFORE the cache lookup: the registry can
    # grow (register_plan) after a decision was cached, and the stale
    # entry must not shadow the widened grid.  The decode shape class
    # (shape.infer) widens the grid to the decode-dedicated plans (s1d)
    # and, being part of ``shape``, keys the cache apart.
    if schedules is not None:
        scheds = tuple(schedules)
    elif mode == "measured":
        scheds = planlib.measured_schedules(infer=shape.infer)
    else:
        scheds = planlib.analytic_schedules(infer=shape.infer)
    key = (shape, mode, tuple(chunk_candidates), pm, wire_candidates,
           scheds, _PLACEMENT_EPOCH)
    if mode == "measured":
        key += (getattr(measure, "device", None),)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit

    if mode == "measured":
        if measure is None:
            raise ValueError("measured mode needs a `measure` callable "
                             "(see autosched.measure_candidates)")
        cands = [((s, n, w) if joint_wire else (s, n))
                 for s in scheds for n in chunk_candidates
                 for w in wire_candidates]
        times = dict(measure(cands))
    else:
        # Each candidate is scored by walking its actual plan graph
        # (PerfModel.t_plan) — the same stages the executor will run.
        # Legacy f32-only grids score with wire_dtype=None (factor 1.0);
        # a joint grid scores each wire dtype at its true byte width
        # relative to PerfModel.wire_bytes_ref.
        times = {}
        for s in scheds:
            for n in chunk_candidates:
                p = planlib.plan_for_shape(s, shape, n)
                for w in wire_candidates:
                    times[(s, n, w) if joint_wire else (s, n)] = \
                        pm.t_plan(p, shape,
                                  wire_dtype=w if joint_wire else None)
    # rank by time; exact ties prefer the wider wire (no silent
    # compression), then candidate-grid order (stable sort).
    ranked = tuple(sorted(
        times.items(),
        key=lambda kv: (kv[1], -WIRE_BYTES[_norm(kv[0])[2]])))
    sched, n_chunks, wire = _norm(ranked[0][0])
    decision = ScheduleDecision(schedule=sched, n_chunks=n_chunks,
                                source=mode, times=ranked,
                                wire_dtype=wire,
                                placement_epoch=_PLACEMENT_EPOCH)
    _CACHE[key] = decision
    # cache-fill only: the cache hits stay silent, so the metrics stream
    # records one decision event per distinct layer line
    obs.emit("autosched_decision", schedule=sched, n_chunks=n_chunks,
             wire=wire, mode=mode,
             infer=bool(getattr(shape, "infer", False)),
             tokens=shape.B * shape.L, d_model=shape.M, E=shape.E,
             placement_epoch=_PLACEMENT_EPOCH)
    return decision


def measure_candidates(cfg, *, tokens: int, d_model: int, iters: int = 3,
                       warmup: int = 1, seed: int = 0,
                       device="cuda") -> Callable:
    """Build a ``measure`` callable timing candidates on ``device``.

    Returns ``f(candidates) -> {candidate: seconds}`` — candidates are
    ``(schedule, n_chunks)`` pairs or ``(schedule, n_chunks, wire_dtype)``
    triples — that runs ``apply_moe`` once per candidate over synthetic
    data of ``tokens`` x ``d_model`` and one layer's random experts
    (made from ``seed``), and records the median over ``iters`` calls
    after ``warmup`` (at least one: the first call builds the kernels).
    On a card each call is timed by a pair of CUDA events on the current
    stream, one synchronize per candidate; on the CPU by the host clock.

    The calibration is usually reached inside a forward, often inside an
    activation-checkpointed block, so it leaves the caller's state as it
    found it: it runs under ``torch.no_grad()``, draws from its own
    ``torch.Generator`` (never the global RNG), restores the step's
    ``moe_call`` ordinals, and suspends the fp8 saturation monitor (a
    synthetic fp8 candidate must never feed the guard's counts).
    Individual failures score ``inf`` and are printed to stderr; if every
    candidate fails it raises.  ``f.device`` names the device (part of
    the measured cache key).
    """
    dev = torch.device(device)

    def run(candidates):
        import time

        from repro_torch.core import collectives, moe
        from repro_torch.core.collectives import CommConfig
        from repro_torch.obs.trace import _median_time

        t_start = time.perf_counter()
        calls = dict(moe._CALLS)
        monitor = collectives._FP8_MONITOR
        collectives.set_fp8_monitor(None)
        out, errors = {}, {}
        try:
            with torch.no_grad():
                gen = torch.Generator(device=dev).manual_seed(seed)
                params = moe.init_moe_params(gen, cfg)
                x = torch.randn((1, tokens, d_model), generator=gen,
                                device=dev)
                for cand in candidates:
                    sched, n_chunks, wire = _norm(cand)
                    c = replace(cfg, schedule=sched,
                                pipeline_chunks=n_chunks,
                                comm=CommConfig(wire_dtype=wire,
                                                scaling=cfg.comm.scaling))
                    try:
                        out[cand] = _median_time(
                            lambda c=c, s=sched: moe.apply_moe(
                                x, params, cfg=c, schedule=s),
                            max(iters, 1), max(warmup, 1), dev)
                    except Exception as e:  # noqa: BLE001 — scored inf
                        out[cand] = float("inf")
                        errors[cand] = repr(e)
                del params, x
        finally:
            moe._CALLS.clear()
            moe._CALLS.update(calls)
            collectives.set_fp8_monitor(monitor)
        if errors and all(t == float("inf") for t in out.values()):
            raise RuntimeError(
                "autosched measured calibration failed for every candidate: "
                + "; ".join(f"{c}: {m}" for c, m in errors.items()))
        for c, m in errors.items():
            # partial failures score inf (never win) but must be visible
            print(f"autosched: candidate {c} failed calibration: {m}",
                  file=sys.stderr, flush=True)
        peak = ""
        if dev.type == "cuda":
            peak = (f", device peak "
                    f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
        print(f"autosched: measured {len(candidates)} candidates at "
              f"{tokens} x {d_model} on {dev} in "
              f"{time.perf_counter() - t_start:.2f} s{peak}",
              file=sys.stderr, flush=True)
        return out

    run.device = str(dev)
    return run
