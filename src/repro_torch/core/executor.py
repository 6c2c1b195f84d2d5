"""Lower a schedule :class:`~repro_torch.core.plan.Plan` to PyTorch, stage
by stage (counterpart of ``repro/core/executor.py``).

``execute`` walks the validated plan graph on this rank, inside the mesh
``apply_moe`` binds (``collectives.bound``), and emits, for each stage
kind, the call sequence of the JAX executor: the collectives of
``repro_torch.core.collectives`` (over this rank's process groups; the
identity plus the wire codec on a one-member group) and the kernel seam's
ops.  All schedule-specific knowledge lives in the plans; this module
knows only how to emit one stage of each kind:

  gate          topk_gate over the stage input's token pool
  dispatch      ``moe_dispatch`` scatter into (E, cap, M)
  mp_split      this rank's slice along the stage's axis
  dispatch_a2a  EP AlltoAll (baseline layout) or fused EP&ESP AlltoAll
                (expert-major dump); ``hier=...`` the two-hop form (s2h)
  expert_ffn    ``expert_ffn`` on the local expert batch
  allreduce     psum over ESP (baseline partial sums)
  combine_a2a   the return AlltoAll; ``saa=True`` the chunked SAA combine
                + MP-AllGather; ``stack_ag=True`` the per-chunk stacked
                AllGather (s2/s2h capacity restore)
  ag_mp         AllGather over ESP (baseline entry, wire-exempt) or MP
                (S1 exit, wire)
  combine       ``moe_combine`` gather + gate-weight mix
  rs_mp         exit split (the baseline's ESP-Split)
  slice/merge   micro-chunk bookkeeping inserted by ``split_capacity``
  expert_ffn_grouped  the dropless grouped FFN (``plan.fuse_grouped``):
                local fused op, its fp8 composition, or the pool form
                (counts AlltoAll + ``expert_ffn_ragged``)

The gate's scalar aux (aux and z losses, drop fraction) come back
``pmean``-ed over every axis of the layer, as in JAX.  Wire precision:
stages with ``wire=True`` get the plan's stamped ``CommConfig`` and call
the ``wire_*`` collective twins; everything else calls the raw
collectives.  A plan that carries an expert placement
(``plan.apply_placement``) runs its stages over the placement's ``R``
physical slots, as the JAX executor does: the gate keeps ``r_e *
placed_cap`` slots for a logical expert with ``r_e`` replicas (a capacity
vector), slot ``s`` of expert ``e`` goes to replica ``s % r_e`` at
physical slot ``s // r_e`` (``gating.flat_slots(placed=)``), dispatch and
combine run over ``R * cap`` rows, and the pool-form grouped stage counts
``ceil((routed_e - j) / r_e)`` rows in replica ``j``.  The expert weights
must already be the placed ones, this rank's ``R / n_ep`` physical slots
(``apply_moe`` exchanges them).  ``execute_prefix`` runs the first k
stages for the stage-timing harness (``repro_torch.obs.trace``).

Where the JAX package leaves the overlap of a plan's collectives to XLA's
async-collective (latency-hiding) scheduler, ``execute`` issues them
itself: a list scheduler over the validated graph (:func:`issue_order`)
starts a collective stage (``dispatch_a2a``, ``combine_a2a``, ``ag_mp``,
``allreduce``) as soon as its deps have been issued, and among the ready
stages takes collectives first, then the stages that launch nothing
(slices), then compute.  A collective stage's value is a
``collectives.Flight``, waited on where its first consumer needs it; so
is the pool form of ``expert_ffn_grouped``, which posts its counts
exchange as it is issued and enqueues the ragged FFN at the wait.  So chunk i+1's dispatch AlltoAll is posted
before chunk i's expert FFN is enqueued (on the card a collective posted
after a kernel waits for it: gloo's copy and NCCL's stream both wait on
the current stream at the post), s2h's chunks have an ESP hop and an EP
hop in flight together, and SAA's AllGather of chunk i travels beside
chunk i+1's AlltoAll.  The order is a function of the plan alone, the
same on every rank, as a process group needs.  ``overlap=False`` (the
tests' and the smoke's serial twin: :func:`serial_issue`) runs the same
functions in ``validate``'s order, each waited on as soon as it is
issued; the bits are the same.  ``execute_prefix`` is serial.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core import collectives as coll
from repro_torch.core.gating import combine, dispatch, topk_gate
from repro_torch.core.plan import INPUT, Plan, validate
from repro_torch.kernels.registry import get_op
from repro_torch.parallel import comm as _comm

#: ``execute``'s default issue mode (``serial_issue`` clears it)
_OVERLAP = True
#: stages that post a collective
_POSTS = ("dispatch_a2a", "combine_a2a", "ag_mp", "allreduce")
#: stages that launch nothing: views of their input
_VIEWS = ("slice", "mp_split", "rs_mp")


def expert_ffn(xb, w1, w3, w2, info):
    """Per-expert FFN on this rank's (El, t, M) batch (the kernel seam's
    ``expert_ffn``).  The weights are this rank's ESP shard (hidden dim
    sliced N_ESP ways), so on more than one ESP rank the output is a
    partial sum that the schedule reduces (psum in the baseline, the
    combine AlltoAll's local sum in S1/S2)."""
    op = get_op("expert_ffn", cfg=info.kernel, act=info.act)
    return op(xb.contiguous(), w1, w3 if info.glu else None, w2)


def _all_axes(info):
    """Every axis of the layer, deduplicated in EP, ESP, MP order, and the
    product of their sizes."""
    axes = tuple(dict.fromkeys(info.ep_axes + info.esp_axes
                               + info.mp_axes))
    mesh = coll.current_mesh()
    n = 1
    if mesh is not None:
        for a in axes:
            n *= mesh.shape[a]
    return axes, n


def _aux_mean(aux, info):
    """The gate's scalar aux ``pmean``-ed over every axis of the layer
    (the identity on one rank); vectors stay this rank's."""
    axes, n = _all_axes(info)
    return {k: (coll.pmean(v, axes, n) if v.dim() == 0 else v)
            for k, v in aux.items()}


def _group(info, key):
    """Resolve a logical axis key to (mesh axis names, group size)."""
    return {"ep": (info.ep_axes, info.n_ep),
            "esp": (info.esp_axes, info.n_esp),
            "mp": (info.mp_axes, info.n_mp)}[key]


def _gate_cap(info, spec: str) -> int:
    """Per-expert capacity for the token pool a gate stage sees."""
    if spec == "pool":           # the unsplit s_local pool (s2, seqpar)
        return info.cap
    if spec == "esp_pool":       # post-ESP-AllGather pool (baseline)
        return info.cap * info.n_esp
    if spec == "mp_shard":       # this MP rank's 1/N_MP slice (s1)
        return info.cap // info.n_mp
    raise ValueError(f"unknown gate cap spec {spec!r}")


class _PlacedTables:
    """An ``ExpertPlacement``'s lookup tables on the layer's device (tiny
    int32 tensors; the placement itself stays on the host)."""

    __slots__ = ("n_phys", "assign", "rep_count", "rep_index", "rep_table")

    def __init__(self, pl, device):
        def t(a):
            return torch.as_tensor(a, dtype=torch.int32, device=device)
        self.n_phys = pl.n_phys
        self.assign = t(pl.assignments)                          # (R,)
        self.rep_count = t(pl.rep_count)                         # (E,)
        self.rep_index = t(pl.replica_index)                     # (R,)
        self.rep_table = t(pl.rep_table)                         # (E, r*)


class _Ctx:
    __slots__ = ("info", "wg", "w1", "w3", "w2", "comm", "gate", "dtype",
                 "placement", "placed", "overlap", "shapes")

    def __init__(self, info, wg, w1, w3, w2, comm, dtype, placement=None,
                 device=None, overlap=False):
        self.info, self.comm, self.overlap = info, comm, overlap
        self.shapes = {}     # dispatch_a2a stage -> its value's shape
        self.wg, self.w1, self.w3, self.w2 = wg, w1, w3, w2
        self.gate = None     # (GateResult, cap) once the gate stage ran
        self.dtype = dtype   # layer-input dtype (raw-wire decode target)
        self.placement = placement
        self.placed = _PlacedTables(placement, device) \
            if placement is not None else None


def _emit(st, vals, ctx):
    """Lower one stage; ``vals`` are its deps' values (or flights) in
    order.  A collective stage returns its ``collectives.Flight``."""
    if st.kind == "expert_ffn_grouped" and not st.p("local"):
        return coll.Flight(_grouped_pool(st, vals[0], ctx))
    vals = [coll.landed(v) for v in vals]
    info = ctx.info
    E = info.gate.n_experts
    Ne, Ns, Nm = info.n_ep, info.n_esp, info.n_mp
    G = info.combined_group
    comm = ctx.comm if st.wire else None
    kind = st.kind

    if kind == "gate":
        cap = _gate_cap(info, st.p("cap", "pool"))
        if ctx.placed is not None:
            # placed: cap becomes the per-physical-slot capacity; the gate
            # keeps r_e * cap slots per logical expert (a capacity vector),
            # so a replicated hot expert drops less
            cap = st.p("placed_cap") or ctx.placement.scaled_cap(cap)
            g = topk_gate(vals[0], ctx.wg, info.gate,
                          ctx.placed.rep_count * cap)
        else:
            g = topk_gate(vals[0], ctx.wg, info.gate, cap)
        ctx.gate = (g, cap)
        return ctx.gate

    if kind == "dispatch":
        tokens, (g, cap) = vals
        if ctx.placed is not None:
            return dispatch(tokens, g.expert_idx, g.slot_idx, cap,
                            ctx.placed.n_phys, info.kernel,
                            flat=g.flat(cap, E, ctx.placed))
        return dispatch(tokens, g.expert_idx, g.slot_idx, cap, E,
                        info.kernel, flat=g.flat(cap, E))

    if kind in ("mp_split", "rs_mp"):
        axes, n = _group(info, st.axes[0])
        return coll.mp_split(vals[0], axes, n, axis=st.p("axis", 0))

    if kind == "ag_mp":
        axes, n = _group(info, st.axes[0])
        axis = st.p("axis", 0)
        if st.wire:
            return coll.wire_mp_all_gather_start(vals[0], axes, n, comm,
                                                 axis=axis)
        return coll.mp_all_gather_start(vals[0], axes, n, axis=axis)

    if kind == "dispatch_a2a":
        d = vals[0]
        if not st.p("fused"):
            # baseline layout: (E, c, M) -> (Ne, El, c, M) EP blocks
            # (the first dim is R physical slots under a placement)
            sb = d.reshape(Ne, d.shape[0] // Ne, d.shape[1], -1)
            return coll.wire_ep_all_to_all_start(
                sb, info.ep_axes, Ne, comm).then(coll.to_expert_batch)
        sb = coll.dump_em(d, Ne, Ns)                    # (El, G, c, M)
        ctx.shapes[st.name] = (sb.shape[0], sb.shape[1] * sb.shape[2],
                               sb.shape[3])
        hier = st.p("hier")
        if hier:
            rb = coll.wire_hier_ep_esp_all_to_all_start(
                sb, info.ep_axes, info.esp_axes, Ne, Ns, comm, axis=1,
                order=hier)
        elif st.p("raw") and coll.wire_raw_ok(comm):
            # grouped-kernel consumer: the payload stays encoded (f32/bf16
            # are plain casts); the ragged FFN's f32 upcast is the decode
            rb = coll.ep_esp_all_to_all_start(
                coll.wire_encode(sb, comm), info.ep_axes, info.esp_axes, G,
                split_axis=1, concat_axis=1)
        else:
            rb = coll.wire_ep_esp_all_to_all_start(
                sb, info.ep_axes, info.esp_axes, G, comm, split_axis=1,
                concat_axis=1)
        return rb.then(coll.to_expert_batch_em)         # (El, G*c, M)

    if kind == "expert_ffn":
        return expert_ffn(vals[0], ctx.w1, ctx.w3, ctx.w2, info)

    if kind == "expert_ffn_grouped":
        return _emit_grouped(st, vals, ctx)

    if kind == "allreduce":
        # comm.psum is synchronous: the stage lands as it is issued
        axes, n = _group(info, st.axes[0])
        return coll.psum(vals[0], axes, n)

    if kind == "combine_a2a":
        return coll.Flight(_combine_back(st, vals[0], ctx))

    if kind == "combine":
        buf, (g, cap) = vals
        return combine(buf, g.expert_idx, g.slot_idx, g.weights, cap,
                       info.kernel, flat=g.flat(cap, E, ctx.placed))

    if kind == "slice":
        i, n = st.p("index"), st.p("n")
        axis = st.p("axis", 1)
        cs = vals[0].shape[axis] // n
        return vals[0].narrow(axis, i * cs, cs)

    if kind == "merge":
        axis = st.p("axis", 1)
        if st.p("mode", "concat") == "concat":
            return (vals[0] if len(vals) == 1
                    else torch.cat(vals, dim=axis))
        # stack_mp: parts are (E|R, Nm*cs, M); restore the (mp_rank, chunk,
        # slot) capacity order of the pre-split buffer
        parts = [p.reshape(p.shape[0], Nm, -1, p.shape[-1]) for p in vals]
        stacked = torch.stack(parts, dim=2)             # (E, Nm, n, cs, M)
        return stacked.reshape(stacked.shape[0], -1, stacked.shape[-1])

    raise ValueError(f"executor: unknown stage kind {kind!r}")


def _combine_back(st, h, ctx):
    """The ``combine_a2a`` stage's flight: the return AlltoAll, then the
    local ESP sum and, under ``stack_ag``, the stacked MP-AllGather,
    started once the AlltoAll has landed (SAA: its own flight)."""
    info, comm = ctx.info, (ctx.comm if st.wire else None)
    Ne, Ns, Nm = info.n_ep, info.n_esp, info.n_mp
    G = info.combined_group
    if not st.p("fused"):
        f = coll.wire_ep_all_to_all_start(
            coll.from_expert_batch(h, Ne), info.ep_axes, Ne, comm)
        yield f
        back = f.wait()
        return back.reshape(back.shape[0] * back.shape[1], back.shape[2],
                            -1)                         # (E|R, c, M)
    y4 = coll.from_expert_batch_em(h, G)
    if st.p("saa"):
        f = coll.saa_combine_allgather_start(
            y4, info.ep_axes, info.esp_axes, info.mp_axes, n_ep=Ne,
            n_esp=Ns, n_mp=Nm, n_chunks=st.p("saa_chunks", info.saa_chunks),
            comm=comm, overlap=ctx.overlap)
        yield f
        return f.wait()                                 # (E, c*Nm, M)
    hier = st.p("hier")
    if hier:
        f = coll.wire_hier_ep_esp_all_to_all_start(
            y4, info.ep_axes, info.esp_axes, Ne, Ns, comm, axis=1,
            order=hier)
    elif st.p("raw") and coll.wire_raw_ok(comm):
        # grouped-kernel producer: its output is already in the wire
        # dtype; move it raw, decode once, then reduce in f32
        f = coll.ep_esp_all_to_all_start(
            y4, info.ep_axes, info.esp_axes, G, split_axis=1,
            concat_axis=1).then(
                lambda b: coll.wire_decode(b, comm, ctx.dtype))
    else:
        f = coll.wire_ep_esp_all_to_all_start(
            y4, info.ep_axes, info.esp_axes, G, comm, split_axis=1,
            concat_axis=1)
    yield f
    mine = coll.undump_reduce_em(f.wait(), Ne, Ns)      # (E|R, c, M)
    if not st.p("stack_ag"):
        return mine
    if Nm == 1:
        part = mine[:, None]                            # (E, 1, c, M)
    else:
        g = coll.wire_all_gather_stacked_start(
            mine, tuple(info.mp_axes), Nm, comm, axis=1)
        yield g
        part = g.wait()
    return part.reshape(mine.shape[0], -1, part.shape[-1])


def _emit_grouped(st, vals, ctx):
    """Lower an ``expert_ffn_grouped`` stage (``plan.fuse_grouped``).

    Local form (``local=True``; deps: token slice + gate): the fused
    ``expert_ffn_grouped`` op, with the f32/bf16 wire round trip at its two
    pool boundaries.  fp8's scale-tail codec cannot fuse, so it composes
    dispatch -> :func:`collectives.wire_roundtrip` -> ``expert_ffn_ragged``
    (one group, counts ``min(load, cap)``) -> wire round trip -> combine.

    Pool form (:func:`_grouped_pool`): exchange the per-(expert, sender)
    routed-row counts over the combined group and run
    ``expert_ffn_ragged`` on the dispatch-AlltoAll receive buffer.
    """
    info = ctx.info
    E = info.gate.n_experts
    comm = ctx.comm if st.wire else None
    tokens, (g, cap) = vals
    wd = getattr(comm, "wire_dtype", "f32") if comm is not None \
        else "f32"
    if coll.wire_raw_ok(comm):
        op = get_op("expert_ffn_grouped", cfg=info.kernel, act=info.act,
                    cap=cap, wire=wd)
        return op(tokens.contiguous(), g.flat(cap, E), g.weights,
                  ctx.w1, ctx.w3 if info.glu else None, ctx.w2)
    d = dispatch(tokens, g.expert_idx, g.slot_idx, cap, E, info.kernel,
                 flat=g.flat(cap, E))                # (E, cap, M)
    d = coll.wire_roundtrip(d, comm)
    cnt = torch.clamp(g.aux["load"], max=float(cap)).to(
        torch.int32)[:, None].contiguous()
    op = get_op("expert_ffn_ragged", cfg=info.kernel, act=info.act)
    h = op(d.reshape(E, 1, cap, -1).contiguous(), cnt, ctx.w1,
           ctx.w3 if info.glu else None, ctx.w2)
    h = coll.wire_roundtrip(h.reshape(E, cap, -1), comm)
    return combine(h, g.expert_idx, g.slot_idx, g.weights, cap,
                   info.kernel, flat=g.flat(cap, E))


def _grouped_pool(st, hv, ctx):
    """The pool form's flight.  The counts exchange starts as the stage
    is issued (it needs only the gate and the receive buffer's shape);
    the wait lands ``hv``, the dispatch AlltoAll's (El, G*c, M) receive
    buffer (maybe raw), and the counts, and enqueues
    ``expert_ffn_ragged``."""
    info = ctx.info
    E = info.gate.n_experts
    Ne, Ns = info.n_ep, info.n_esp
    G = info.combined_group
    g, cap = ctx.gate
    El, Gc, M = ctx.shapes[st.deps[0]]
    c = Gc // G
    # this chunk covers capacity slots [ci*c, (ci+1)*c) of every expert;
    # slots are contiguous from 0, so its routed rows per expert are
    # clip(routed - ci*c, 0, c)
    ci = st.p("chunk_index", 0)
    if ctx.placed is not None:
        # placed: rows of logical expert e land round-robin on its
        # replicas, so physical slot p (replica j of expert a_p) holds
        # ceil((routed_a - j) / r_a) rows, contiguous from 0
        t = ctx.placed
        routed = torch.minimum(g.aux["load"],
                               (t.rep_count * cap).float()).to(torch.int32)
        r = t.rep_count[t.assign.long()]
        cnt_p = torch.clamp(torch.div(routed[t.assign.long()] - t.rep_index
                                      + r - 1, r, rounding_mode="floor"),
                            0, cap)                                # (R,)
        cnt = torch.clamp(cnt_p - ci * c, 0, c)
        nl = t.n_phys // Ne                  # this rank's physical slots
    else:
        routed = torch.clamp(g.aux["load"], max=float(cap)).to(torch.int32)
        cnt = torch.clamp(routed - ci * c, 0, c)                 # (E,)
        nl = E // Ne
    snd = cnt.reshape(Ne, nl).T[:, :, None].expand(nl, Ne, Ns).reshape(
        nl, G)
    counts = coll.ep_esp_all_to_all_start(snd, info.ep_axes, info.esp_axes,
                                          G, split_axis=1, concat_axis=1)
    yield counts
    h = coll.landed(hv)
    rcv = counts.wait()                                          # (El, G)
    op = get_op("expert_ffn_ragged", cfg=info.kernel, act=info.act)
    out = op(h.reshape(El, G, c, M).contiguous(), rcv.contiguous(), ctx.w1,
             ctx.w3 if info.glu else None, ctx.w2)
    return out.reshape(El, Gc, M)


def _start(plan: Plan, x, wg, w1, w3, w2, info, overlap=False):
    """(validated stage order, fresh context) for one run of ``plan``."""
    return validate(plan), _Ctx(info, wg, w1, w3, w2,
                                getattr(plan, "comm", None), x.dtype,
                                getattr(plan, "placement", None), x.device,
                                overlap)


def _rank(st) -> int:
    """The list scheduler's preference: collectives, then stages that
    launch nothing, then compute (the pool form of ``expert_ffn_grouped``
    among them: it posts its counts exchange as it is issued, and its
    flight enqueues the FFN when a consumer waits on it)."""
    if st.kind in _POSTS:
        return 0
    return 1 if st.kind in _VIEWS else 2


def issue_order(order) -> tuple:
    """The order ``execute`` issues the stages of ``order`` (``validate``'s)
    in: repeatedly the ready stage (every dep issued) of the lowest
    :func:`_rank`, the first in ``order`` among equals.  A function of
    the plan alone, so every rank posts its collectives in one order.

    For a 2-chunk ``s1_pipe`` the dispatch AlltoAlls of both chunks come
    before the first expert FFN:

    >>> from repro_torch.core.plan import build_plan
    >>> from repro_torch.core.schedules import MoEShardInfo
    >>> from repro_torch.core.gating import GateConfig
    >>> info = MoEShardInfo(("ep",), ("esp",), ("mp",), 2, 2, 2, 64, 16,
    ...                     GateConfig(n_experts=8, top_k=2),
    ...                     pipeline_chunks=2)
    >>> [s.name for s in issue_order(validate(build_plan("s1", info)))]
    ... # doctest: +NORMALIZE_WHITESPACE
    ['split', 'gate', 'disp', 'chunk0/slice', 'a2a_d@0', 'chunk1/slice',
     'a2a_d@1', 'ffn@0', 'a2a_c@0', 'ffn@1', 'a2a_c@1', 'merge', 'comb',
     'ag_out']
    """
    left, issued, out = list(order), {INPUT}, []
    while left:
        st = min((s for s in left if all(d in issued for d in s.deps)),
                 key=_rank)
        left.remove(st)
        issued.add(st.name)
        out.append(st)
    return tuple(out)


@contextlib.contextmanager
def serial_issue():
    """Run every :func:`execute` inside as ``overlap=False`` (the serial
    twin that the tests and the smoke hold the overlapped issue to)."""
    global _OVERLAP
    prev, _OVERLAP = _OVERLAP, False
    try:
        yield
    finally:
        _OVERLAP = prev


def execute(plan: Plan, x, wg, w1, w3, w2, info, *, overlap=None):
    """Run one MoE layer under ``plan`` on this rank.  ``x`` is the (S, M)
    token slice; returns ``(y, aux)`` with the gate's aux (aux and z
    losses and drop fraction ``pmean``-ed over the layer's axes; this
    rank's load and routed rows).  Under a placed plan the expert weights
    are this rank's physical slots (the module docstring).

    The stages are issued in :func:`issue_order`, each collective's value
    waited on where a consumer needs it; ``overlap=False`` (default: as
    :func:`serial_issue` says, else True) issues them in ``validate``'s
    order, each waited on at once.  Raises if a collective it posted is
    still in flight when it returns."""
    overlap = _OVERLAP if overlap is None else overlap
    order, ctx = _start(plan, x, wg, w1, w3, w2, info, overlap)
    env = {INPUT: x}
    with _comm.collecting() as posted:
        for st in (issue_order(order) if overlap else order):
            with _comm.tagged(st.name):
                v = _emit(st, [env[d] for d in st.deps], ctx)
            env[st.name] = v if overlap else coll.landed(v)
        y = coll.landed(env[plan.output])
    left = [h.tag for h in posted if not h.done]
    if left:
        raise RuntimeError(f"plan {plan.name!r}: execute returns with "
                           f"{len(left)} collectives in flight: {left}")
    if ctx.gate is None:
        raise ValueError(f"plan {plan.name!r} has no gate stage")
    g, _ = ctx.gate
    return y, _aux_mean(g.aux, info)


def _probe(v):
    """Scalar fingerprint of one stage value (the gate stage's is the sum
    of its weights)."""
    if isinstance(v, tuple):             # gate stage: (GateResult, cap)
        return v[0].weights.float().sum()
    return v.float().sum()


def execute_prefix(plan: Plan, x, wg, w1, w3, w2, info, n_stages: int):
    """Run only the first ``n_stages`` stages of ``plan`` (validated topo
    order) and return a 0-d f32 tensor folding a probe of the input and of
    every stage output, ``psum``-ed over the layer's axes, as the JAX
    ``execute_prefix`` returns it.

    The stage-timing harness (``repro_torch.obs.trace``) times the prefixes
    k = 0..n and charges stage k the difference of prefixes k and k - 1.
    The topo order lists every stage after its deps, so any prefix is a
    closed subgraph, and the gate result is in the context before a
    consumer runs."""
    order, ctx = _start(plan, x, wg, w1, w3, w2, info)
    env = {INPUT: x}
    acc = x.float().sum()
    for st in order[:n_stages]:
        env[st.name] = coll.landed(_emit(st, [env[d] for d in st.deps], ctx))
        acc = acc + _probe(env[st.name])
    axes, n = _all_axes(info)
    return coll.psum(acc, axes, n)
