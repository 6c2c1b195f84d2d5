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
    observed winner is recorded.  On a mesh every rank times the same
    candidates in lockstep and takes the slowest rank's time (JAX's
    ``block_until_ready`` waits for every device), so every rank picks
    the same winner.

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
fallback.

The placement registry (:func:`set_placement`, :func:`current_placement`)
holds the expert placement that ``MoEConfig(placement="auto")`` layers
run, and keys decisions by placement epoch as in JAX.
:func:`decide_placement` prices a load-derived placement against uniform
with the skew-aware cost model, and :func:`maybe_rebalance` (the
``Trainer``'s and the ``Engine``'s trigger) installs one that wins on
every layer shape decided so far; on a mesh every rank is held to the
same outcome before any rank installs it.
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
    A ``measure`` built for a mesh carries ``agree``, which holds every
    rank to the same key, hit or miss, before any rank calibrates.
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
    agree = getattr(measure, "agree", None) if mode == "measured" else None
    if agree is not None:
        # a rank that calibrates enters collectives: every rank must make
        # the same choice, hit or miss, over the same candidates (the key
        # holds the grid)
        agree(key, hit is not None)
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


def decide_placement(shape, loads, *, schedule, n_chunks: int = 1,
                     candidate=None, perf_model: Optional[PerfModel] = None,
                     capacity_factor: float = 1.0, top_k: int = 1,
                     margin: float = 1.05, max_replicas=None):
    """Score a load-derived expert placement against uniform for one
    layer shape (the JAX function, with the card's ``h100_model`` as the
    default cost model).

    Builds ``candidate`` (default: ``placement_from_loads`` over the
    observed per-expert ``loads``), prices the layer's plan both ways
    with the skew-aware cost model (``PerfModel.t_plan(..., loads=...)``
    — uniform pays the max-rank load inflation, the placed plan pays its
    shrunk pool at its own residual imbalance), and returns
    ``(placement_or_None, t_placed, t_uniform)`` where the placement is
    ``None`` unless it beats uniform by at least ``margin``.
    """
    from repro_torch.core.placement import placement_from_loads

    pm = perf_model or h100_model(shape.n_ep, shape.n_esp, shape.n_mp)
    if candidate is None:
        candidate = placement_from_loads(
            loads, shape.n_ep, n_experts=shape.E,
            capacity_factor=capacity_factor, top_k=top_k,
            max_replicas=max_replicas, epoch=_PLACEMENT_EPOCH + 1)
    t_uni = pm.t_plan(planlib.plan_for_shape(schedule, shape, n_chunks),
                      shape, loads=loads)
    if candidate is None or candidate.is_identity:
        return None, t_uni, t_uni
    t_cand = pm.t_plan(
        planlib.plan_for_shape(schedule, shape, n_chunks,
                               placement=candidate), shape, loads=loads)
    win = t_cand * margin < t_uni
    return (candidate if win else None), t_cand, t_uni


#: ``maybe_rebalance``'s outcome without a change (the JAX function's None)
_KEEP = object()


def _rebalance_outcome(loads, *, margin, capacity_factor, top_k,
                       perf_model, max_replicas, infer):
    """What ``maybe_rebalance`` would install (a placement, or None for
    uniform), ``_KEEP`` for no change, and the modeled times of the
    candidate and of uniform on each shape it scored."""
    import numpy as np

    from repro_torch.core.placement import identity_placement
    from repro_torch.core.placement import placement_from_loads

    loads = np.asarray(loads, dtype=np.float64)
    seen, todo = set(), []
    for key, d in _CACHE.items():
        shape = key[0]
        if bool(getattr(shape, "infer", False)) != infer:
            continue
        if shape.n_ep <= 1 or shape.E != loads.size:
            continue
        sk = (shape, d.schedule, d.n_chunks)
        if sk in seen:
            continue
        seen.add(sk)
        todo.append(sk)
    if not todo:
        return _KEEP, []
    n_ep = todo[0][0].n_ep
    cand = placement_from_loads(
        loads, n_ep, n_experts=int(loads.size),
        capacity_factor=capacity_factor, top_k=top_k,
        max_replicas=max_replicas, epoch=_PLACEMENT_EPOCH + 1)
    if infer and cand.cap_frac < 1.0:
        # decode layers run drop-free (apply_moe forces cap_frac=1.0), so
        # score the candidate the way decode will run it; a capacity-
        # shrink-only candidate (no replication) is a bare permutation at
        # full capacity: uniform
        cand = identity_placement(cand.n_experts, n_ep) \
            if cand.n_phys == cand.n_experts \
            else replace(cand, cap_frac=1.0)
    if cand.is_identity:
        # loads evened out: back to uniform, if a placement is installed
        return (None if _PLACEMENT is not None else _KEEP), []
    cur = _PLACEMENT
    if cur is not None and cur.assignments == cand.assignments \
            and abs(cur.cap_frac - cand.cap_frac) < 0.05:
        return _KEEP, []     # already running (close enough to) this one
    priced = []
    for shape, sched, nc in todo:
        if shape.n_ep != n_ep:
            continue  # placement is per EP degree; skip foreign meshes
        got, t_cand, t_uni = decide_placement(
            shape, loads, schedule=sched, n_chunks=nc, candidate=cand,
            perf_model=perf_model, margin=margin)
        priced.append((shape, sched, nc, t_cand, t_uni))
        if got is None:
            return _KEEP, priced
    return cand, priced


def maybe_rebalance(loads, *, margin: float = 1.05,
                    capacity_factor: float = 1.0, top_k: int = 1,
                    perf_model: Optional[PerfModel] = None,
                    max_replicas=None, infer: bool = False, mesh=None,
                    device="cpu"):
    """The rebalance trigger (the JAX function): derive a placement from
    the live load EMA, score it against uniform over every compatible
    cached decision, and install it on a win.

    ``loads`` is the smoothed per-expert load vector (``LoadEMA.value``).
    Candidate shapes come from the decision cache — the layers this
    process has decided for (``infer`` selects the decode class), so a
    layer under a forced schedule never rebalances.  The candidate must
    beat uniform by ``margin`` on *every* compatible shape (the placement
    is process-wide, so a loss anywhere vetoes).  On a win
    :func:`set_placement` installs it and the new epoch is returned; if
    the loads have evened out (identity candidate) while a placement is
    installed, the placement is cleared (also a new epoch).  Returns None
    when nothing changes.

    On a ``mesh`` every rank is held to one outcome first: one
    ``comm.agree`` of a digest of the placement it would install (its
    assignments and ``cap_frac``, "none" for uniform, "keep" for no
    change), on every call, so a rank that would install another
    placement raises on every rank and none is left waiting.  The
    modeled times of the last call (candidate and uniform per shape)
    stay in ``last_rebalance_times()``."""
    global _LAST_PRICED
    out, _LAST_PRICED = _rebalance_outcome(
        loads, margin=margin, capacity_factor=capacity_factor,
        top_k=top_k, perf_model=perf_model, max_replicas=max_replicas,
        infer=infer)
    if mesh is not None and mesh.size > 1:
        import zlib

        from repro_torch.parallel import comm
        what = ("keep" if out is _KEEP else "none" if out is None else
                (tuple(out.assignments), repr(out.cap_frac)))
        comm.agree([zlib.crc32(repr(what).encode())],
                   mesh.group(mesh.axis_names),
                   f"the expert placement to install (crc of {what!r})",
                   device)
    if out is _KEEP:
        return None
    return set_placement(out)


_LAST_PRICED: list = []


def last_rebalance_times() -> list:
    """``(shape, schedule, n_chunks, t_placed, t_uniform)`` for each shape
    the last :func:`maybe_rebalance` call priced (modeled seconds)."""
    return list(_LAST_PRICED)


def measure_candidates(cfg, *, tokens: int, d_model: int, iters: int = 3,
                       warmup: int = 1, seed: int = 0,
                       device="cuda", mesh=None, dims=None) -> Callable:
    """Build a ``measure`` callable timing candidates on ``device`` (and,
    with ``mesh`` and ``dims``, on every rank of the mesh together).

    Returns ``f(candidates) -> {candidate: seconds}`` — candidates are
    ``(schedule, n_chunks)`` pairs or ``(schedule, n_chunks, wire_dtype)``
    triples — that runs ``apply_moe`` once per candidate over synthetic
    data of ``tokens`` x ``d_model`` and one layer's random experts
    (made from ``seed``), and records the median over ``iters`` calls
    after ``warmup`` (at least one: the first call builds the kernels).
    On a card each call is timed by a pair of CUDA events on the current
    stream, one synchronize per candidate; on the CPU by the host clock.

    On a mesh ``tokens`` is the global pool, as in JAX: every rank draws
    the same pool and experts from ``seed``, keeps its shards of the
    experts and hands ``apply_moe(..., replicated=True)`` the pool, whose
    boundary cuts this rank's rows.  Every rank resolves every candidate
    first and the ranks agree on which resolved everywhere, so none
    enters a candidate's collectives that another skips; then each times
    the candidates in one order, and one ``pmax`` over the mesh gives
    every rank each candidate's slowest median and whether it failed on
    any rank (a failure there scores ``inf`` everywhere).  A candidate
    that resolves everywhere but raises on one rank inside its
    collectives leaves the others waiting in them, as a failing step
    would.
    ``f.agree`` holds the ranks to one cache key and one candidate list
    before :func:`decide` reads its cache (see there).

    The calibration is usually reached inside a forward, often inside an
    activation-checkpointed block, so it leaves the caller's state as it
    found it: it runs under ``torch.no_grad()``, draws from its own
    ``torch.Generator`` (never the global RNG), restores the step's
    ``moe_call`` ordinals, and suspends the fp8 saturation monitor (a
    synthetic fp8 candidate must never feed the guard's counts).
    Individual failures score ``inf`` and are printed to stderr; if every
    candidate fails it raises.  ``f.device`` names the device, and on a
    mesh the mesh too (part of the measured cache key).
    """
    dev = torch.device(device)
    on_mesh = mesh is not None and mesh.size > 1

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
                if on_mesh:
                    from repro_torch.parallel.sharding import local_tree
                    params = local_tree(
                        params, moe.moe_param_specs(cfg, mesh, dims), mesh)
                calls_of = {}
                for cand in candidates:
                    sched, n_chunks, wire = _norm(cand)
                    c = replace(cfg, schedule=sched,
                                pipeline_chunks=n_chunks,
                                comm=CommConfig(wire_dtype=wire,
                                                scaling=cfg.comm.scaling))
                    try:
                        calls_of[cand] = (moe._mesh_call(
                            x, params, c, mesh, dims, sched, None, False,
                            True) if on_mesh else
                            lambda c=c, s=sched: moe.apply_moe(
                                x, params, cfg=c, schedule=s))
                    except Exception as e:  # noqa: BLE001 — scored inf
                        errors[cand] = repr(e)
                if on_mesh:
                    from repro_torch.parallel import comm
                    world = mesh.group(mesh.axis_names)
                    ok = comm.pmax(torch.tensor(
                        [float(c not in calls_of) for c in candidates],
                        dtype=torch.float64, device=dev), world).tolist()
                    for cand, bad in zip(candidates, ok):
                        if bad and cand in calls_of:
                            del calls_of[cand]
                            errors[cand] = "failed to resolve on another rank"
                for cand in candidates:
                    if cand not in calls_of:
                        out[cand] = float("inf")
                        continue
                    try:
                        out[cand] = _median_time(
                            calls_of[cand], max(iters, 1), max(warmup, 1),
                            dev)
                    except Exception as e:  # noqa: BLE001 — scored inf
                        out[cand] = float("inf")
                        errors[cand] = repr(e)
                if on_mesh:
                    # the slowest rank's median, and any rank's failure
                    got = comm.pmax(torch.tensor(
                        [[out[c] for c in candidates],
                         [float(c in errors) for c in candidates]],
                        dtype=torch.float64, device=dev), world).tolist()
                    for cand, t, bad in zip(candidates, *got):
                        out[cand] = float("inf") if bad else t
                        if bad and cand not in errors:
                            errors[cand] = "failed on another rank"
                del params, x, calls_of
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
        where = run.device.replace("|", " on ")
        print(f"autosched: measured {len(candidates)} candidates at "
              f"{tokens} x {d_model} on {where} in "
              f"{time.perf_counter() - t_start:.2f} s{peak}",
              file=sys.stderr, flush=True)
        return out

    run.device = str(dev)
    if on_mesh:
        run.device += "|" + ",".join(f"{a}={n}"
                                     for a, n in mesh.shape.items())

        def agree(key, hit):
            """Hold every rank to this cache key (its candidate grid
            included), hit or miss (``comm.agree``: a difference raises on
            every rank).  The key's device names the card's index, which
            differs between ranks on several cards: its type stands in."""
            import zlib

            from repro_torch.parallel import comm
            shared = key[:-1] + (dev.type + run.device[len(str(dev)):],)
            comm.agree([zlib.crc32(repr(shared).encode()), int(hit)],
                       mesh.group(mesh.axis_names),
                       "the measured autoscheduler's cache key and "
                       "candidates (crc) and whether it is cached", dev)

        run.agree = agree
    return run
