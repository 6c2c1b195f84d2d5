"""The schedule-plan IR (a copy of ``repro/core/plan.py``).

The JAX package's plan IR imports only the standard library, so the port
keeps it as it is: the same stages, transforms, registry and printouts,
the lazy imports of ``plan_for_shape`` pointed at the port's modules.
``tests/test_torch_plan.py`` holds every registered schedule's
``plan_summary``/``format_plan`` to the JAX package's.  The port's
``repro_torch.core.executor`` lowers a plan to PyTorch.  The JAX
module's own description follows.

The schedule-plan IR: Parm's schedule space as *data*, not code.

PR 2 and PR 3 multiplied the hand-written schedule bodies: four base
schedules x {unchunked, pipelined} x wire dtypes, each separately
threading ``flat_slots`` caching, ``CommConfig`` encoding and aux-loss
plumbing.  FSMoE (arXiv:2501.10714) models an MoE layer as a graph of
schedulable comm/compute *tasks* precisely because that makes new
schedules cheap; this module is that graph.

A :class:`Plan` is a tuple of :class:`Stage` nodes — ``gate``,
``dispatch_a2a``, ``ag_mp``, ``expert_ffn``, ``combine_a2a``,
``allreduce``, ... — with explicit data deps (stage names), logical axis
groups (``"ep"``/``"esp"``/``"mp"``, resolved to mesh axis names at
execution), and wire annotations.  Three consumers walk the same graph:

  * the executor lowers a plan inside a shard_map body (JAX) or on
    one rank (the port), emitting the identical ``wire_*`` collectives
    and registry kernels the hand-written bodies used (exact-parity-tested
    against the golden legacy bodies in ``tests/helpers/legacy_bodies.py``);
  * ``PerfModel.t_plan`` walks it to predict the layer time (one cost
    model source of truth — no per-schedule closed form to keep in sync);
  * ``python -m repro_torch.launch.dryrun --dump-plan`` serializes it
    for debugging.

Axes of the schedule space are *graph transforms*, not new bodies:
:func:`split_capacity` turns any plan into its chunk-pipelined variant
(PR 2's ``*_pipe`` family, generated), :func:`apply_wire` stamps the
collective payload dtype (PR 3's wire family, generated).  New schedules
register a ~20-line builder with :func:`register_plan` and are
automatically part of the autoscheduler's candidate grid.

The doctest examples run under
``python -m doctest`` on this file.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Optional

#: Stage kinds the executor and the cost model understand.
KINDS = (
    "gate",          # top-k routing over a token pool -> GateResult
    "dispatch",      # local scatter into the (E, cap, M) capacity buffer
    "mp_split",      # take this rank's 1/N slice (free fwd, AG bwd)
    "dispatch_a2a",  # EP (plain) or EP&ESP (fused) AlltoAll, token-bound
    "expert_ffn",    # per-expert FFN through the kernel registry
    "expert_ffn_grouped",  # ragged grouped-GEMM megakernel (fuse_grouped)
    "allreduce",     # in-network partial-sum reduction (baseline ESP)
    "combine_a2a",   # return AlltoAll (+ local ESP reduce / SAA / hier)
    "ag_mp",         # AllGather over an MP-like group
    "combine",       # local gather + gate-weight mix back to token order
    "rs_mp",         # exit split (reduce-scatter-shaped: free fwd, AG bwd)
    "slice",         # capacity-dim micro-chunk slice (split_capacity)
    "merge",         # chunk reassembly (split_capacity)
)

#: Logical axis groups a stage may communicate over.
AXIS_KEYS = ("ep", "esp", "mp")

#: Payload-size symbols (paper Table I terms) for ``PerfModel.t_plan``.
SIZES = ("blm", "etm", "blm*esp", "etm*esp", "etm*esp/mp")

#: Reserved environment name for the layer input.
INPUT = "x"


@dataclass(frozen=True)
class Stage:
    """One node of a schedule plan.

    ``deps`` name producer stages (``"x"`` is the layer input); ``axes``
    are logical group keys from :data:`AXIS_KEYS` (the executor resolves
    them to mesh axis names via ``MoEShardInfo``); ``wire=True`` lets
    :func:`apply_wire` put this stage's payload on the fabric in the
    plan's wire dtype; ``size`` is the payload symbol ``t_plan`` charges;
    ``chunk=True`` marks the stage as part of the :func:`split_capacity`
    region.  ``params`` holds static kind-specific knobs as a sorted
    tuple of pairs (kept hashable); read them with :meth:`p`.
    """

    name: str
    kind: str
    deps: tuple = ()
    axes: tuple = ()
    wire: bool = False
    size: str = ""
    chunk: bool = False
    params: tuple = ()

    def p(self, key: str, default=None):
        """Kind-specific param lookup.

        >>> stage("s", "gate", deps=("x",), cap="pool").p("cap")
        'pool'
        """
        for k, v in self.params:
            if k == key:
                return v
        return default

    def with_params(self, **kw) -> "Stage":
        """Copy of this stage with ``kw`` merged into ``params``."""
        d = dict(self.params)
        d.update(kw)
        return dataclasses.replace(self, params=tuple(sorted(d.items())))


def stage(name: str, kind: str, deps=(), *, axes=(), wire=False, size="",
          chunk=False, **params) -> Stage:
    """Convenience constructor packing ``**params`` into the sorted
    tuple form :class:`Stage` stores.

    >>> stage("g", "gate", deps=("x",), cap="pool").kind
    'gate'
    """
    return Stage(name=name, kind=kind, deps=tuple(deps), axes=tuple(axes),
                 wire=wire, size=size, chunk=chunk,
                 params=tuple(sorted(params.items())))


@dataclass(frozen=True)
class Plan:
    """A full schedule as a stage graph plus its transform metadata.

    ``base`` is the underlying paper schedule (for the cost model's
    compute term — the baseline redundantly computes all MP copies);
    ``output`` names the stage whose value is the layer output.
    ``chunk_input``/``chunk_output``/``chunk_axis``/``chunk_size``/
    ``merge`` describe the :func:`split_capacity` region; ``n_chunks``,
    ``comm`` and ``placement`` record what transforms have been applied.
    """

    name: str
    stages: tuple
    output: str
    base: str = ""
    n_chunks: int = 1
    comm: object = None          # CommConfig once apply_wire has run
    chunk_input: str = ""        # stage whose output the region slices
    chunk_output: str = ""       # region stage feeding the merge
    chunk_axis: int = 1
    chunk_size: int = 0          # capacity-dim size (for chunk clamping)
    merge: str = "concat"        # "concat" | "stack_mp"
    placement: object = None     # ExpertPlacement once apply_placement ran

    def stage_names(self):
        return tuple(s.name for s in self.stages)

    def find(self, name: str) -> Stage:
        for s in self.stages:
            if s.name == name:
                return s
        raise KeyError(name)


class PlanError(ValueError):
    """A malformed plan: cycle, dangling dep, bad kind/axis/param."""


def validate(plan: Plan):
    """Check a plan and return its stages in a stable topological order.

    Rejects duplicate or reserved stage names, unknown kinds, axis keys
    outside :data:`AXIS_KEYS`, dangling deps, a missing output stage,
    and dependency cycles (Kahn's algorithm; ties resolve in listed
    order, which is also the order the executor emits ops in).

    >>> p = Plan("t", (stage("a", "gate", deps=("x",)),), output="a")
    >>> [s.name for s in validate(p)]
    ['a']
    >>> bad = Plan("t", (stage("a", "gate", deps=("b",)),
    ...                  stage("b", "dispatch", deps=("a",))), output="a")
    >>> try:
    ...     validate(bad)
    ... except PlanError as e:
    ...     print(e)
    plan 't': dependency cycle through ['a', 'b']
    """
    names = [s.name for s in plan.stages]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise PlanError(f"plan {plan.name!r}: duplicate stage names {dupes}")
    if INPUT in names:
        raise PlanError(f"plan {plan.name!r}: stage name {INPUT!r} is "
                        "reserved for the layer input")
    known = set(names)
    for s in plan.stages:
        if s.kind not in KINDS:
            raise PlanError(f"plan {plan.name!r}: stage {s.name!r} has "
                            f"unknown kind {s.kind!r} (want one of {KINDS})")
        for ax in s.axes:
            if ax not in AXIS_KEYS:
                raise PlanError(
                    f"plan {plan.name!r}: stage {s.name!r} names bad axis "
                    f"{ax!r} (want one of {AXIS_KEYS})")
        if s.size and s.size not in SIZES:
            # an unknown symbol would silently price the collective at
            # zero bandwidth in PerfModel.t_plan, skewing autosched
            raise PlanError(
                f"plan {plan.name!r}: stage {s.name!r} has unknown size "
                f"symbol {s.size!r} (want one of {SIZES})")
        for d in s.deps:
            if d != INPUT and d not in known:
                raise PlanError(f"plan {plan.name!r}: stage {s.name!r} "
                                f"depends on undefined stage {d!r}")
    if plan.output not in known:
        raise PlanError(f"plan {plan.name!r}: output stage "
                        f"{plan.output!r} is not defined")
    # Kahn's algorithm, preferring listed order among ready stages so the
    # executor's op order is deterministic and matches the builders'.
    by_name = {s.name: s for s in plan.stages}
    indeg = {n: sum(1 for d in by_name[n].deps if d != INPUT)
             for n in names}
    dependents: dict = {n: [] for n in names}
    for s in plan.stages:
        for d in s.deps:
            if d != INPUT:
                dependents[d].append(s.name)
    order, ready = [], [n for n in names if indeg[n] == 0]
    while ready:
        n = ready.pop(0)
        order.append(n)
        for m in dependents[n]:
            indeg[m] -= 1
            if indeg[m] == 0:
                ready.append(m)
        ready.sort(key=names.index)
    if len(order) != len(names):
        cyc = sorted(set(names) - set(order), key=names.index)
        raise PlanError(f"plan {plan.name!r}: dependency cycle through "
                        f"{cyc}")
    return tuple(by_name[n] for n in order)


# --- graph transforms --------------------------------------------------------

def clamp_chunks(cap: int, want: int) -> int:
    """Largest divisor of ``cap`` that is <= ``want`` (and >= 1).

    >>> clamp_chunks(16, 5), clamp_chunks(7, 2), clamp_chunks(12, 0)
    (4, 1, 1)
    """
    n = max(1, min(want, cap))
    while cap % n:
        n -= 1
    return n


def split_capacity(plan: Plan, n_chunks: int, *, clamp: bool = True) -> Plan:
    """Chunk-pipeline transform: replicate the plan's chunkable region
    ``n_chunks`` times over capacity-dim micro-chunks.

    Each clone gets its own ``slice`` entry node and a remapped dep set,
    so the chunks are independent subgraphs: in the JAX package XLA's
    async collective scheduler overlaps chunk i+1's communication with
    chunk i's FFN; in the port ``executor.execute``'s list scheduler
    posts chunk i+1's AlltoAll before it enqueues chunk i's FFN and
    waits on each collective where its first consumer needs it.  A ``merge`` node reassembles the parts
    (``plan.merge`` mode).  Stages may declare chunk-dependent params:

      * ``alt=(v0, v1, ...)`` alternates the stage's ``hier`` hop order
        per chunk (the s2h intra/inter overlap);
      * an SAA combine collapses to depth 1 inside a chunk (the chunk
        itself *is* the SAA unit — same decomposition, one level up).

    ``n_chunks`` clamps to the largest divisor of ``plan.chunk_size``
    unless ``clamp=False`` (the cost model scores unclamped grids, same
    as the legacy ``t_pipelined``).  ``n_chunks <= 1`` or a plan with no
    chunk region returns the plan unchanged.
    """
    chunked = [s for s in plan.stages if s.chunk]
    n = max(1, n_chunks)
    if clamp and plan.chunk_size:
        n = clamp_chunks(plan.chunk_size, n)
    if n <= 1 or not chunked:
        return dataclasses.replace(plan, n_chunks=1)
    if not plan.chunk_input or not plan.chunk_output:
        raise PlanError(f"plan {plan.name!r}: chunk stages but no "
                        "chunk_input/chunk_output region declared")
    names = [s.name for s in plan.stages]
    first = min(names.index(s.name) for s in chunked)
    last = max(names.index(s.name) for s in chunked)
    if any(not s.chunk for s in plan.stages[first:last + 1]):
        raise PlanError(f"plan {plan.name!r}: chunk region must be "
                        "contiguous in stage order")
    region = {s.name for s in chunked}
    pre, post = plan.stages[:first], plan.stages[last + 1:]
    for s in post:
        bad = [d for d in s.deps if d in region and d != plan.chunk_output]
        if bad:
            raise PlanError(
                f"plan {plan.name!r}: stage {s.name!r} depends on chunk-"
                f"internal stage(s) {bad}; only {plan.chunk_output!r} is "
                "visible after the merge")

    out = list(pre)
    for i in range(n):
        out.append(stage(f"chunk{i}/slice", "slice",
                         deps=(plan.chunk_input,), chunk=True,
                         index=i, n=n, axis=plan.chunk_axis,
                         chunk_index=i))
        for s in chunked:
            deps = tuple(
                f"chunk{i}/slice" if d == plan.chunk_input
                else (f"{d}@{i}" if d in region else d)
                for d in s.deps)
            c = dataclasses.replace(s, name=f"{s.name}@{i}", deps=deps)
            c = c.with_params(chunk_index=i)
            alt = s.p("alt")
            if alt:
                c = c.with_params(hier=alt[i % len(alt)])
            if s.kind == "combine_a2a" and s.p("saa"):
                c = c.with_params(saa_chunks=1)
            out.append(c)
    out.append(stage("merge", "merge",
                     deps=tuple(f"{plan.chunk_output}@{i}"
                                for i in range(n)),
                     mode=plan.merge, axis=plan.chunk_axis))
    for s in post:
        deps = tuple("merge" if d == plan.chunk_output else d
                     for d in s.deps)
        out.append(dataclasses.replace(s, deps=deps))
    output = "merge" if plan.output == plan.chunk_output else plan.output
    return dataclasses.replace(plan, stages=tuple(out), n_chunks=n,
                               output=output)


def apply_wire(plan: Plan, comm) -> Plan:
    """Wire-precision transform: stamp the collective payload format.

    Stages with ``wire=True`` will ship their payload in
    ``comm.wire_dtype`` (the executor passes ``comm`` to the ``wire_*``
    collective twins); wire-exempt stages (the baseline's pre-gate
    AllGather and in-network AllReduce) are untouched.  ``comm`` must be
    concrete — ``"auto"`` is resolved by ``autosched.decide`` before any
    plan executes.
    """
    if comm is not None and getattr(comm, "wire_dtype", "f32") == "auto":
        raise PlanError("apply_wire needs a concrete wire dtype; resolve "
                        "CommConfig.wire_dtype='auto' via autosched first")
    return dataclasses.replace(plan, comm=comm)


def apply_placement(plan: Plan, placement, *, info=None) -> Plan:
    """Expert-placement transform: remap the dispatch/combine A2A stages
    onto a (possibly replicated) physical expert layout and stamp the
    shrunk per-rank capacity.

    ``placement`` is an ``ExpertPlacement`` (``None`` returns the plan
    unchanged).  The transform

      * stamps the gate stage with ``placed_cap`` — the per-physical-slot
        capacity derived from this plan's gate-pool spec via
        ``placement.scaled_cap`` (aligned to ``lcm(8, n_mp)`` when an
        ``mp_split`` on the capacity dim follows, so the s2 family's
        1/N_MP slices stay exact);
      * marks the dispatch/combine and A2A stages ``placed=True`` (the
        executor derives buffer geometry from the physical slot count,
        splits each logical expert's traffic across its replicas
        round-robin by capacity slot, and gathers each token back from
        the one replica that computed it — the replica-fractional
        dispatch / summed combine);
      * rescales ``chunk_size`` so :func:`split_capacity` keeps slicing
        the placed buffer exactly.

    Composes with :func:`split_capacity` (apply placement *first*: the
    chunk clones inherit the stamped params), :func:`apply_wire`, and
    the pool form of :func:`fuse_grouped`.  The local fused megakernel
    (single-rank EP) has nothing to remap and is rejected.
    """
    if placement is None:
        return plan
    gate = next((s for s in plan.stages if s.kind == "gate"), None)
    if gate is None:
        raise PlanError(f"plan {plan.name!r}: apply_placement needs a "
                        "gate stage")
    if any(s.p("local") for s in plan.stages
           if s.kind == "expert_ffn_grouped"):
        raise PlanError(
            f"plan {plan.name!r}: placement does not compose with the "
            "local fused megakernel (single-rank EP has nothing to remap)")
    n_mp = max(int(getattr(info, "n_mp", 1) or 1), 1) if info else 1
    n_esp = max(int(getattr(info, "n_esp", 1) or 1), 1) if info else 1
    cap = int(getattr(info, "cap", 0) or 0) if info else 0
    spec = gate.p("cap", "pool")
    logical = {"pool": cap, "esp_pool": cap * n_esp,
               "mp_shard": cap // n_mp}[spec]
    # s2-family plans mp_split the dispatch buffer's capacity dim *after*
    # the gate: the placed pool cap must stay divisible by n_mp and the
    # chunk region slices the 1/N_MP shard.
    pool_split = any(s.kind == "mp_split" and s.p("axis", 0) == 1
                     for s in plan.stages)
    align = (8 * n_mp // math.gcd(8, n_mp)) if pool_split else 8
    placed_cap = placement.scaled_cap(logical, align=align) if logical \
        else 0
    stages = []
    for s in plan.stages:
        if s.kind == "gate":
            s = s.with_params(placed_cap=placed_cap)
        elif s.kind in ("dispatch", "combine", "dispatch_a2a",
                        "combine_a2a", "expert_ffn_grouped"):
            s = s.with_params(placed=True)
        stages.append(s)
    chunk_size = plan.chunk_size
    if chunk_size and placed_cap:
        chunk_size = placed_cap // n_mp if pool_split else placed_cap
    return dataclasses.replace(plan, stages=tuple(stages),
                               placement=placement, chunk_size=chunk_size)


def fuse_grouped(plan: Plan, *, local: bool = False) -> Plan:
    """Grouped-megakernel transform: route the plan's expert FFN through
    the dropless ragged grouped-GEMM kernel, absorbing the adjacent
    dispatch/combine/wire work into the kernel's prologue/epilogue.

    ``local=False`` (the multi-device pool form) swaps the ``expert_ffn``
    stage's kind to ``expert_ffn_grouped`` — the executor feeds it the
    dispatch-AlltoAll receive buffer plus exchanged per-(expert, sender)
    routed-row counts, so capacity padding tiles are predicated off the
    MXU — and stamps ``raw=True`` on the adjacent fused AlltoAll stages:
    for plain-cast wire dtypes (f32/bf16) the payload stays *encoded*
    across the kernel boundary (the kernel's f32 upcast is the decode,
    its output cast the encode), eliding two full-buffer codec passes.
    fp8's scale-tail payload cannot cross the boundary raw; the executor
    falls back to the decoded path at run time (``raw`` is advisory).

    ``local=True`` (single-member combined group, ``n_mp == 1``)
    collapses dispatch -> AlltoAll -> FFN -> AlltoAll -> combine into
    ONE ``expert_ffn_grouped`` stage: the fused megakernel gathers
    routed token rows in its prologue and scatter-adds the gate-weighted
    outputs in its epilogue — no (E*cap, M) intermediates in HBM.  The
    fused stage reuses the combine stage's name so downstream deps need
    no rewiring, and the chunk region is dissolved (``split_capacity``
    becomes a no-op: there is no standalone AlltoAll left to overlap).
    """
    ffn = next((s for s in plan.stages if s.kind == "expert_ffn"), None)
    if ffn is None:
        raise PlanError(f"plan {plan.name!r}: fuse_grouped needs an "
                        "expert_ffn stage")
    if not local:
        out = []
        for s in plan.stages:
            if s.name == ffn.name:
                s = dataclasses.replace(s, kind="expert_ffn_grouped")
            elif (s.kind in ("dispatch_a2a", "combine_a2a")
                    and s.p("fused") and not s.p("saa")
                    and not s.p("hier")
                    and (ffn.name in s.deps or s.name in ffn.deps)):
                s = s.with_params(raw=True)
            out.append(s)
        return dataclasses.replace(plan, stages=tuple(out))
    gate = next(s for s in plan.stages if s.kind == "gate")
    disp = next(s for s in plan.stages if s.kind == "dispatch")
    comb = next(s for s in plan.stages if s.kind == "combine")
    region = {disp.name, comb.name} | {
        s.name for s in plan.stages
        if s.kind in ("dispatch_a2a", "expert_ffn", "combine_a2a")}
    token_src = next(d for d in disp.deps if d != gate.name)
    fused = stage(comb.name, "expert_ffn_grouped",
                  deps=(token_src, gate.name), wire=True, local=True)
    out = tuple(fused if s.name == comb.name else s
                for s in plan.stages
                if s.name not in region - {comb.name})
    return dataclasses.replace(plan, stages=out, chunk_input="",
                               chunk_output="", chunk_size=0)


# --- the plan registry -------------------------------------------------------

@dataclass(frozen=True)
class PlanEntry:
    """One registered schedule: its builder plus autosched eligibility.

    ``analytic``/``measured`` gate which decision grids enumerate it
    (``s1_seqpar`` is neither: it needs the sequence-parallel activation
    contract, so it is only ever forced; ``baseline`` is measured-only —
    Algorithm 1 proves S1/S2 dominate it analytically, §IV-B).
    ``decode_only`` marks decode-dedicated schedules (``s1d``): they are
    enumerated only for the *inference* shape class — decode pools are a
    handful of tokens, where trading redundant MP compute for one fewer
    collective wins, which is never true at training sizes.
    """

    builder: Callable
    analytic: bool = True
    measured: bool = True
    decode_only: bool = False


PLANS: dict = {}


def register_plan(name: str, builder: Optional[Callable] = None, *,
                  analytic: bool = True, measured: bool = True,
                  decode_only: bool = False):
    """Register a schedule plan builder (usable as a decorator).

    ``builder(info) -> Plan`` takes the ``MoEShardInfo`` (or any object
    with the same static fields) and returns the *unchunked, unwired*
    base plan.  Registration makes the schedule selectable by name and —
    per its flags — part of the autoscheduler's candidate grids
    (``decode_only=True`` restricts it to the decode grids).
    """
    def deco(fn):
        PLANS[name] = PlanEntry(builder=fn, analytic=analytic,
                                measured=measured, decode_only=decode_only)
        return fn
    return deco if builder is None else deco(builder)


def analytic_schedules(infer: bool = False) -> tuple:
    """Registered schedules the analytic decision grid enumerates.
    ``infer=True`` is the decode grid: it adds the decode-dedicated
    plans the training grid never scores."""
    return tuple(n for n, e in PLANS.items()
                 if e.analytic and (infer or not e.decode_only))


def measured_schedules(infer: bool = False) -> tuple:
    """Registered schedules the measured decision grid enumerates
    (``infer=True``: the decode grid, incl. decode-only plans)."""
    return tuple(n for n, e in PLANS.items()
                 if e.measured and (infer or not e.decode_only))


def build_plan(name: str, info, n_chunks: Optional[int] = None) -> Plan:
    """Build the executable plan for one schedule on one layer layout:
    base plan -> :func:`apply_placement` (from ``info.placement``) ->
    :func:`split_capacity` (clamped) -> :func:`apply_wire`.

    ``n_chunks`` defaults to ``info.pipeline_chunks``; pass ``1`` for
    the always-unchunked public body aliases.
    """
    if name not in PLANS:
        raise KeyError(f"no plan registered for schedule {name!r} "
                       f"(have {sorted(PLANS)})")
    base = PLANS[name].builder(info)
    pl = getattr(info, "placement", None)
    if pl is not None:
        base = apply_placement(base, pl, info=info)
    want = info.pipeline_chunks if n_chunks is None else n_chunks
    p = split_capacity(base, want)
    return apply_wire(p, getattr(info, "comm", None))


def plan_for_shape(name: str, shape, n_chunks: int = 1,
                   placement=None) -> Plan:
    """Build a plan from a ``MoELayerShape`` alone (cost-model scoring).

    Constructs a minimal stand-in layout (dummy axis names, capacity
    from the shape's ``T``) and expands the chunk region *unclamped*, so
    scored grids match the requested candidates exactly — the runtime
    clamps real chunk counts before asking for a decision.  Passing an
    ``ExpertPlacement`` scores its placed variant (``t_plan`` prices the
    shrunk pool and the rank-load skew).
    """
    from repro_torch.core.gating import GateConfig
    from repro_torch.core.schedules import MoEShardInfo

    cap = max(int(shape.T), 1)
    info = MoEShardInfo(
        ep_axes=("ep",), esp_axes=("esp",), mp_axes=("mp",),
        n_ep=shape.n_ep, n_esp=shape.n_esp, n_mp=shape.n_mp,
        tokens=shape.B * shape.L, cap=cap,
        gate=GateConfig(n_experts=shape.E, top_k=shape.k,
                        capacity_factor=shape.f))
    base = PLANS[name].builder(info)
    if placement is not None:
        base = apply_placement(base, placement, info=info)
    return split_capacity(base, n_chunks, clamp=False)


def plan_summary(plan: Plan) -> dict:
    """JSON-ready description of a plan's stage graph (the
    ``repro_torch.launch.dryrun --dump-plan`` artifact payload)."""
    wd = getattr(plan.comm, "wire_dtype", "f32") if plan.comm else "f32"
    pl = plan.placement
    return {
        "name": plan.name,
        "base": plan.base or plan.name,
        "n_chunks": plan.n_chunks,
        "wire_dtype": wd,
        "merge": plan.merge if plan.n_chunks > 1 else None,
        "placement": pl.summary() if pl is not None else None,
        "output": plan.output,
        "stages": [
            {"name": s.name, "kind": s.kind, "deps": list(s.deps),
             "axes": list(s.axes),
             "wire": (wd if s.wire else None),
             "chunk": s.p("chunk_index") if s.chunk else None,
             **({"hier": s.p("hier")} if s.p("hier") else {})}
            for s in plan.stages],
    }


def format_plan(plan: Plan) -> str:
    """One line per stage, for run logs and ``--dump-plan`` printouts."""
    wd = getattr(plan.comm, "wire_dtype", "f32") if plan.comm else "f32"
    head = (f"plan {plan.name} (base={plan.base or plan.name}, "
            f"n_chunks={plan.n_chunks}, wire={wd})")
    if plan.placement is not None:
        pl = plan.placement
        head += (f" placed[R={pl.n_phys} cap_frac={pl.cap_frac:.2f} "
                 f"epoch={pl.epoch}]")
    lines = [head]
    for s in plan.stages:
        bits = [s.kind]
        if s.axes:
            bits.append("axes=" + "x".join(s.axes))
        if s.wire:
            bits.append(f"wire={wd}")
        if s.p("hier"):
            bits.append(f"hier={s.p('hier')}")
        deps = ", ".join(s.deps) or "-"
        lines.append(f"  {s.name:18s} {' '.join(bits):34s} <- {deps}")
    return "\n".join(lines)
