"""The MoE layer (counterpart of ``repro/core/moe.py``).

``apply_moe`` runs every schedule of the JAX package's ``SCHEDULES`` (and
any schedule registered with ``plan.register_plan``) through the ported
plan IR: ``schedules.BODY[name]`` or the ``*_pipe`` bodies build the plan
and ``executor.execute`` lowers it.  With ``mesh=None`` it is the layer on
one rank (``n_ep = n_esp = n_mp = 1``): every collective is the identity
plus the wire codec, so every schedule runs gate -> ``moe_dispatch`` ->
(wire) -> ``expert_ffn`` -> (wire) -> ``moe_combine``, and ``s1g`` the
fused ``expert_ffn_grouped`` (or, on an fp8 wire, dispatch ->
``expert_ffn_ragged`` -> combine).

With a :class:`~repro_torch.parallel.mesh.Mesh` and ``ParallelDims`` it
is the JAX layer's shard_map body on this rank: ``x`` is this rank's block
of the activations (the batch over ``dims.batch_axes``, replicated over
the rest), the parameters this rank's shards (``moe_param_specs``), and
the collectives run over its process groups.  ``s1_seqpar`` takes its MP
slice of the rows and gathers the output back; a pool too small to split
(fewer tokens a rank than MP ranks) gathers the pool over the batch axes
and runs the ``dense_decode`` fallback, ``_replicated_body``.  The
gradients are JAX's: the boundary divides the cotangent of a replicated
output by its replication and sums an input's cotangent over the
non-batch axes it is replicated on; the batch axes' sum is the
trainer's (``train.loop.sync_grads``), so a layer's gradients summed
that way equal ``jax.grad`` of the JAX layer's.  Shared experts run
outside the body, on the whole pool, column / row parallel over MP where
``moe_param_specs`` shards them (JAX's GSPMD layout, written out).

``schedule="auto"`` and ``CommConfig(wire_dtype="auto")`` resolve
through ``autosched.decide`` as in the JAX ``apply_moe``: analytically
from the cost model (``core/perfmodel.py``, the card's ``h100_model`` by
default) or, under ``autosched="measured"``, from a one-shot calibration
of every candidate on the layer's device.  At one rank the analytic
decision is ``s1g`` with one chunk on the f32 wire at every serving and
training shape (``tests/test_torch_moe.py``, ``tests/test_torch_train.py``
pin it).  On a mesh the analytic decision is priced with ``h100_model(n_ep,
n_esp, n_mp)`` and checked equal on every rank at its first call; the
measured calibration times every candidate on the live mesh, every rank
taking the slowest rank's time (``autosched.measure_candidates``), after
the ranks agree on the cache key, hit or miss, and the candidates.

Expert placement (``MoEConfig.placement``: None, ``"auto"`` or an
``ExpertPlacement``) resolves as in JAX: ``"auto"`` reads
``autosched.current_placement()`` at each call (the rebalance loop's swap
point: the next call after ``autosched.set_placement`` runs the new one),
and a placement is dropped under the ``dense_decode`` fallback, on fewer
than two EP ranks and when its ``n_experts`` or ``n_ep`` is not the
layer's; a decode pool keeps its replication at full capacity.  The plan
then runs over the placement's ``R`` physical slots (``executor``), and
each rank computes its ``R / n_ep`` of them: ``_PlacedWeights`` sends
each rank exactly the logical experts its slots compute, over the EP
group (``comm.all_to_all_rows``), and its backward sends every replica's
gradient home, summed there in slot order (JAX's take-VJP of the placed
weights).  An identity placement moves nothing and leaves the layer
bitwise as it is unplaced.

``replicated=True`` (on a mesh) takes the whole pool on every rank, as
the serving engine holds its rows and as JAX's replicated array enters
its shard_map: the layer cuts this rank's block of the pool's tokens
(the batch axes, and MP under ``s1_seqpar``), runs the body, and gathers
the pool's output back onto every rank, bitwise the same on each.  It
has no backward (the engine's steps and the calibration run without
autograd).

Telemetry: the layer's body runs under ``obs.trace_tag(moe_call=,
schedule=, wire=)``, so the fp8 saturation events it records say which
call, schedule and wire they belong to.  ``moe_call`` is the layer's call
ordinal within the step (the runtime context's ``step``; with none set it
counts from the first call).  JAX's counts traces instead
(``_TRACE_ORDINAL``, which a re-jit advances); PyTorch has no trace, and
an activation-checkpointed block's recompute is a call of its own.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core import autosched, executor
from repro_torch.core import collectives as coll
from repro_torch.core import plan as planlib
from repro_torch.core.collectives import CommConfig
from repro_torch.core.gating import GateConfig, capacity
from repro_torch.core.perfmodel import MoELayerShape, PerfModel, h100_model
from repro_torch.core.pipeline import PIPELINE_OF, UNCHUNKED_OF, clamp_chunks
from repro_torch.core.schedules import BODY, SCHEDULES, MoEShardInfo
from repro_torch.kernels.registry import KernelConfig
from repro_torch.parallel.mesh import ParallelDims, axis_size
from repro_torch.parallel.sharding import P, replicated_axes
from repro_torch.parallel.tensor import copy_to_mp, reduce_from_mp

_CALLS = {"step": None, "n": 0}   # moe_call ordinals of the current step


def _next_call() -> int:
    """This call's ordinal within the runtime context's step."""
    step = obs.event_context().get("step")
    if step != _CALLS["step"]:
        _CALLS["step"], _CALLS["n"] = step, 0
    n = _CALLS["n"]
    _CALLS["n"] = n + 1
    return n


@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                     # per-expert hidden size
    n_experts: int
    top_k: int = 1
    capacity_factor: float = 1.25
    n_shared_experts: int = 0     # llama4-style shared expert(s)
    glu: bool = True              # SwiGLU experts
    normalize_topk: bool = False
    aux_loss_weight: float = 1e-2
    z_loss_weight: float = 1e-3
    schedule: str = "auto"        # any name in schedules.SCHEDULES, or a
    #   schedule registered via plan.register_plan
    saa_chunks: int = 4
    pipeline_chunks: int = 1      # micro-chunks for the *_pipe bodies (1 = off)
    autosched: str = "analytic"   # "auto" decision mode: analytic | measured
    act: str = "silu"             # expert activation ("silu" | "gelu")
    kernel: KernelConfig = KernelConfig()
    comm: CommConfig = CommConfig()  # wire format: f32 | bf16 | fp8_e4m3;
    #   "auto" lets the autoscheduler pick f32-vs-bf16 jointly with
    #   (schedule, n_chunks)
    placement: object = None      # expert placement: None (uniform) |
    #   "auto" (the live placement of autosched's registry, read at each
    #   call: the rebalance loop's swap point) | an ExpertPlacement

    def gate_config(self) -> GateConfig:
        return GateConfig(
            n_experts=self.n_experts, top_k=self.top_k,
            capacity_factor=self.capacity_factor,
            normalize_topk=self.normalize_topk,
            aux_loss_weight=self.aux_loss_weight,
            z_loss_weight=self.z_loss_weight)


def init_moe_params(generator, cfg: MoEConfig, dtype=torch.float32) -> dict:
    """Parameters in the JAX package's layout: wg (M, E) f32, w1/w3
    (E, M, F), w2 (E, F, M), shared_* for shared experts; made on
    ``generator``'s device from its stream."""
    M, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dev = generator.device

    def normal(shape, scale, dt=dtype):
        t = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return t.mul_(scale).to(dt)

    scale_in, scale_out = 1.0 / math.sqrt(M), 1.0 / math.sqrt(F)
    p = {"wg": normal((M, E), scale_in, torch.float32),
         "w1": normal((E, M, F), scale_in),
         "w2": normal((E, F, M), scale_out)}
    if cfg.glu:
        p["w3"] = normal((E, M, F), scale_in)
    if cfg.n_shared_experts:
        Fs = F * cfg.n_shared_experts
        p["shared_w1"] = normal((M, Fs), scale_in)
        p["shared_w3"] = normal((M, Fs), scale_in)
        p["shared_w2"] = normal((Fs, M), 1.0 / math.sqrt(Fs))
    return p


def moe_param_specs(cfg: MoEConfig, mesh, dims: ParallelDims) -> dict:
    """PartitionSpecs: experts over EP, hidden over ESP, gate replicated
    (the JAX function, copied)."""
    def ep_ok(n):
        return dims.ep and n % axis_size(mesh, dims.ep) == 0

    def esp_ok(n):
        return dims.esp and n % axis_size(mesh, dims.esp) == 0

    E, F, M = cfg.n_experts, cfg.d_ff, cfg.d_model
    e_ax = tuple(dims.ep) if ep_ok(E) else None
    f_ax = tuple(dims.esp) if esp_ok(F) else None
    specs = {
        "wg": P(None, None),
        "w1": P(e_ax, None, f_ax),
        "w2": P(e_ax, f_ax, None),
    }
    if cfg.glu:
        specs["w3"] = P(e_ax, None, f_ax)
    if cfg.n_shared_experts:
        mp_ax = tuple(dims.mp) if dims.mp and (
            F * cfg.n_shared_experts) % axis_size(mesh, dims.mp) == 0 else None
        specs["shared_w1"] = P(None, mp_ax)
        specs["shared_w3"] = P(None, mp_ax)
        specs["shared_w2"] = P(mp_ax, None)
    return specs


def shard_pool_capacity(tokens_global: int, n_token_shard: int, n_mp: int,
                        gate_cfg: GateConfig, infer: bool = False):
    """(s_local, cap) for one device's token pool — the JAX package's
    capacity formula, verbatim.  ``infer=True`` (decode pools) raises cap
    to cover the whole pool, so no token is dropped and a row's output is
    independent of its batch mates."""
    s_local = tokens_global // max(n_token_shard, 1)
    align = max(8, n_mp)
    cap = max(align, -(-capacity(max(s_local, 1), gate_cfg)
                       // align) * align)
    if infer:
        cap = max(cap, -(-max(s_local, 1) // align) * align)
    return s_local, cap


def layer_info(cfg: MoEConfig, tokens: int, n_chunks: int = 1,
               infer: bool = False, wire=None) -> MoEShardInfo:
    """The one-rank ``MoEShardInfo`` of a layer over ``tokens`` tokens, as
    ``apply_moe`` derives it (also the stage-trace harness's layout).
    ``wire`` is the resolved wire dtype (default: the config's, with
    ``"auto"`` read as f32, as the JAX audit harness reads it)."""
    gate_cfg = cfg.gate_config()
    s_local, cap = shard_pool_capacity(tokens, 1, 1, gate_cfg, infer=infer)
    comm = cfg.comm or CommConfig()
    if wire is None:
        wire = "f32" if comm.wire_dtype == "auto" else comm.wire_dtype
    return MoEShardInfo(
        ep_axes=("ep",), esp_axes=("esp",), mp_axes=("mp",), n_ep=1,
        n_esp=1, n_mp=1, tokens=s_local, cap=cap, gate=gate_cfg,
        act=cfg.act, glu=cfg.glu, saa_chunks=cfg.saa_chunks,
        pipeline_chunks=n_chunks, kernel=cfg.kernel,
        # the guard rails' wire ceiling (fp8 overflow fallback), applied
        # to the resolved wire as the JAX apply_moe applies it
        comm=CommConfig(wire_dtype=autosched.clamp_wire(wire),
                        scaling=comm.scaling))


def select_schedule(cfg: MoEConfig, shape: MoELayerShape,
                    perf_model: Optional[PerfModel] = None) -> str:
    """Schedule name for one layer shape (no chunk count; see
    ``autosched.decide`` for the full (schedule, n_chunks) decision)."""
    if cfg.schedule != "auto":
        return cfg.schedule
    pm = perf_model or h100_model(shape.n_ep, shape.n_esp, shape.n_mp)
    return autosched.decide(shape, perf_model=pm).schedule


def resolve_schedule(cfg: MoEConfig, schedule=None, *, B: int = 1,
                     L: int = 1, infer: bool = False,
                     perf_model: Optional[PerfModel] = None,
                     device="cpu", n_ep: int = 1, n_esp: int = 1,
                     n_mp: int = 1, n_token_shard: int = 1, mesh=None,
                     dims: Optional[ParallelDims] = None):
    """(schedule name, n_chunks, wire dtype) that ``apply_moe`` runs for a
    global (B, L) token pool split over ``n_token_shard`` ranks, as the JAX
    ``apply_moe`` resolves them: ``"auto"`` (schedule or wire) asks
    ``autosched.decide`` for the layer's ``MoELayerShape`` — chunk
    candidates clamped to the chunked capacity ``cap // n_mp`` (one chunk
    for a decode pool), a forced schedule with an ``"auto"`` wire
    restricting the grid to itself, a calibration on ``device`` (and on
    ``mesh``, every rank in lockstep) under ``autosched="measured"`` —
    then the wire ceiling applies, and a chunk count > 1 routes a base
    schedule to its ``*_pipe`` body."""
    sched = schedule or cfg.schedule
    n_chunks = max(cfg.pipeline_chunks, 1)
    wire = (cfg.comm or CommConfig()).wire_dtype
    if sched == "auto" or wire == "auto":
        s_local, cap = shard_pool_capacity(B * L, n_token_shard, n_mp,
                                           cfg.gate_config(), infer=infer)
        shape = MoELayerShape(
            B=max(s_local // max(L, 1), 1), L=min(L, s_local),
            M=cfg.d_model, H=cfg.d_ff, E=cfg.n_experts, k=cfg.top_k,
            f=cfg.capacity_factor, n_mp=n_mp, n_esp=n_esp, n_ep=n_ep,
            infer=infer)
        # only chunk counts the bodies can run (scored == executed); a
        # decode pool never chunks
        cands = ((1,) if infer else
                 tuple(sorted({clamp_chunks(cap // max(n_mp, 1), n)
                               for n in autosched.DEFAULT_CHUNKS})))
        forced = None
        if sched != "auto":
            forced = (UNCHUNKED_OF.get(sched, sched),)
            cands = (clamp_chunks(cap // max(n_mp, 1), n_chunks),)
        wire_cands = autosched.AUTO_WIRE if wire == "auto" else (wire,)
        measure = (autosched.measure_candidates(
            cfg, tokens=B * L, d_model=cfg.d_model, device=device,
            mesh=mesh, dims=dims)
            if cfg.autosched == "measured" else None)
        decision = autosched.decide(shape, perf_model=perf_model,
                                    mode=cfg.autosched,
                                    chunk_candidates=cands,
                                    wire_candidates=wire_cands,
                                    schedules=forced, measure=measure)
        if sched == "auto":
            sched, n_chunks = decision.schedule, decision.n_chunks
        wire = decision.wire_dtype if wire == "auto" else wire
    wire = autosched.clamp_wire(wire)
    if n_chunks > 1 and sched in PIPELINE_OF:
        sched = PIPELINE_OF[sched]
    if sched not in BODY and UNCHUNKED_OF.get(sched, sched) \
            not in planlib.PLANS:
        raise KeyError(f"unknown schedule {sched!r}: not in schedules.BODY "
                       f"nor the plan registry (have "
                       f"{sorted(set(SCHEDULES) | set(planlib.PLANS))})")
    return sched, n_chunks, wire


def apply_moe(x, params: dict, *, cfg: MoEConfig, mesh=None,
              dims: Optional[ParallelDims] = None, schedule=None,
              perf_model: Optional[PerfModel] = None, infer: bool = False,
              replicated: bool = False):
    """One MoE layer under the configured schedule.  x: (B, L, M), the
    whole pool on one rank (``mesh=None``) or this rank's block of it on a
    mesh, or with ``replicated=True`` the whole pool on every rank of the
    mesh (see the module docstring).  Returns ``(y, aux)`` with aux
    ``aux_loss``, ``z_loss``, ``drop_frac`` and ``expert_load`` (the (E,)
    routed rows; on a mesh all four ``pmean``-ed over every axis), as the
    JAX ``apply_moe`` returns them.

    ``infer=True`` marks a decode pool (drop-free capacity); prefill
    pools (``infer=False``) take the training capacity, so padding rows of
    a prefill bucket compete for slots exactly as in the JAX engine.
    ``perf_model`` prices ``"auto"`` (default: the card's ``h100_model``).
    """
    if mesh is not None:
        if dims is None:
            raise ValueError("apply_moe(mesh=...) needs dims=")
        return _mesh_call(x, params, cfg, mesh, dims, schedule,
                          perf_model, infer, replicated)()
    B, L, M = x.shape
    sched, n_chunks, wire = resolve_schedule(
        cfg, schedule, B=B, L=L, infer=infer, perf_model=perf_model,
        device=x.device)
    info = layer_info(cfg, B * L, n_chunks, infer=infer, wire=wire)
    y, gaux = _run_body(sched, x.reshape(B * L, M), params, cfg, info)
    y = y.reshape(B, L, M).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + _shared_experts(x, params)
    aux = {k: gaux[k] for k in ("aux_loss", "z_loss", "drop_frac")}
    aux["expert_load"] = gaux["routed"]
    return y, aux


def _shared_experts(x, params, grp=None):
    """The shared experts' SwiGLU FFN on the whole pool ``x``, outside the
    routed body (as JAX runs it outside its shard_map).  With ``grp`` (the
    MP group, where ``moe_param_specs`` shards them) ``params`` holds this
    rank's columns of ``shared_w1`` / ``shared_w3`` and rows of
    ``shared_w2``: column / row parallel over MP
    (``parallel.tensor.copy_to_mp`` / ``reduce_from_mp``)."""
    if grp is not None:
        x = copy_to_mp(x, grp)
    h = torch.einsum("blm,mf->blf", x, params["shared_w1"])
    h = torch.nn.functional.silu(h) * torch.einsum(
        "blm,mf->blf", x, params["shared_w3"])
    y = torch.einsum("blf,fm->blm", h, params["shared_w2"])
    return y if grp is None else reduce_from_mp(y, grp)


def _run_body(sched, xt, ws, cfg, info):
    """``sched``'s body on the flat pool ``xt`` with the weights ``ws``,
    under the layer's trace tag; returns ``(y, gaux)``."""
    body = _replicated_body if sched == "dense_decode" else BODY.get(sched)
    if body is None:
        # a schedule registered via plan.register_plan without a BODY
        # alias: execute its plan directly, chunked per pipeline_chunks
        base = UNCHUNKED_OF.get(sched, sched)

        def body(xt, wg, w1, w3_, w2, info):
            return executor.execute(planlib.build_plan(base, info), xt, wg,
                                    w1, w3_, w2, info)
    with obs.trace_tag(moe_call=_next_call(), schedule=sched,
                       wire=info.comm.wire_dtype):
        return body(xt, ws["wg"], ws["w1"], ws.get("w3") if cfg.glu else None,
                    ws["w2"], info)


# --- the layer on a mesh ----------------------------------------------------

class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the cotangent times ``scale`` (the shard
    boundary's division of a replicated output's cotangent)."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _PsumGrad(torch.autograd.Function):
    """Identity forward; the cotangent ``psum``-ed over ``axes`` (the shard
    boundary's sum of an input's cotangent over its replicated axes)."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.parallel import comm
        return comm.psum(g.contiguous(), ctx.grp), None


def _boundary_in(t, spec, mesh, dims):
    """``t`` (an input block under ``spec``) with its cotangent summed over
    the non-batch axes it is replicated on."""
    batch = set(dims.batch_axes)
    axes = tuple(a for a in replicated_axes(spec, mesh) if a not in batch)
    n = axis_size(mesh, axes)
    if n == 1 or not t.requires_grad:
        return t
    return _PsumGrad.apply(t, mesh.group(axes))


def _boundary_out(t, n: int):
    """``t`` (an output replicated ``n`` ways) with its cotangent / n."""
    if n == 1 or not t.requires_grad:
        return t
    return _ScaleGrad.apply(t, 1.0 / n)


_AGREED = set()   # resolutions already checked equal on all ranks


def _check_agreed(mesh, key, sched, n_chunks, wire, device) -> None:
    """The first time a mesh resolves a layer, all-gather the decision
    over every axis and require the same pick on every rank (the analytic
    decision is deterministic; this holds it to that).  ``key`` holds only
    what every rank shares (the resolution's inputs, not its pick), so the
    ranks enter the all-gather together, and a rank that picks otherwise
    raises instead of leaving the others waiting."""
    key = (id(mesh),) + key
    if key in _AGREED or torch.device(device).type == "meta":
        return      # a meta trace (the dry run) is one rank's: no values
    from repro_torch.parallel import comm
    names = sorted(set(BODY) | set(planlib.PLANS))
    pick = [names.index(sched), n_chunks,
            autosched.AUTO_WIRE.index(wire)
            if wire in autosched.AUTO_WIRE else 99]
    comm.agree(pick, mesh.group(mesh.axis_names),
               f"the MoE schedule (names {names})", device)
    _AGREED.add(key)


def resolve_placement(cfg, n_ep: int, use_fallback: bool, infer: bool):
    """The placement a layer runs (None: uniform), as the JAX ``apply_moe``
    resolves it: ``"auto"`` reads autosched's live placement; a placement
    is dropped under the decode fallback, on fewer than two EP ranks and
    when its ``n_experts`` or ``n_ep`` is not the layer's; a decode pool
    (``infer``) keeps the replication at full capacity (its capacity
    covers the pool, so ``r_e * cap`` does too)."""
    pl = cfg.placement
    if pl == "auto":
        pl = autosched.current_placement()
    if pl is not None and (use_fallback or n_ep <= 1
                           or pl.n_experts != cfg.n_experts
                           or pl.n_ep != n_ep):
        return None
    if pl is not None and infer and pl.cap_frac < 1.0:
        pl = replace(pl, cap_frac=1.0)
    return pl


class _SlotExchange:
    """The placed expert weights' exchange over the EP group ``grp``, from
    the host-side placement ``pl``: rank ``i`` holds logical experts ``[i
    El, (i + 1) El)`` (``moe_param_specs``) and computes physical slots
    ``[i Rl, (i + 1) Rl)``.  Calling it on this rank's block of a weight
    returns its (Rl, ...) physical slots (``_PlacedWeights``).  Every rank
    derives the same tables, so every rank makes the same choice: no
    exchange at all where no slot's expert lives on another rank (an
    identity placement returns the block itself), else one
    ``comm.all_to_all_rows`` moving exactly the slots' experts that live
    on other ranks (this rank's own rows never leave the device)."""

    def __init__(self, pl, grp):
        n, me = grp.size, grp.index
        E, R = pl.n_experts, pl.n_phys
        El, Rl = E // n, R // n
        a = pl.assignments
        self.grp = grp
        # rows this rank sends member j: its local experts of j's slots,
        # in slot order; rows it receives from member j: the slot
        # positions of its own slots whose expert lives on j
        self.send_idx = [[a[p] - me * El for p in range(j * Rl, (j + 1) * Rl)
                          if a[p] // El == me] for j in range(n)]
        self.recv_pos = [[p - me * Rl for p in range(me * Rl, (me + 1) * Rl)
                          if a[p] // El == j] for j in range(n)]
        self.cross = any(a[p] // El != p // Rl for p in range(R))
        self.identity = (not self.cross and [a[p] - me * El for p in range(
            me * Rl, (me + 1) * Rl)] == list(range(El)))
        pos = [q for j in range(n) for q in self.recv_pos[j]]
        inv = [0] * Rl
        for k, q in enumerate(pos):
            inv[q] = k
        self.inv, self.pos = inv, pos
        self.send = [e for j in range(n) for e in self.send_idx[j]]

    def __call__(self, w):
        if self.identity:
            return w
        return _PlacedWeights.apply(w, self)

    def _move(self, x, send_rows, recv_rows):
        """``x`` holds ``send_rows[j]`` rows for the member of JAX index
        ``j``, in that order; returns the rows received, ``recv_rows[j]``
        from member ``j``, in that order.  This rank's own rows stay on
        the device; the others' go through ``comm.all_to_all_rows``."""
        from repro_torch.parallel import comm
        me = self.grp.index
        off, n_own = sum(send_rows[:me]), send_rows[me]
        own = x.narrow(0, off, n_own)
        if not self.cross:
            return own
        others = torch.cat([x.narrow(0, 0, off), x.narrow(
            0, off + n_own, x.shape[0] - off - n_own)])
        got = comm.all_to_all_rows(
            others, self.grp, [0 if j == me else c
                               for j, c in enumerate(send_rows)],
            [0 if j == me else c for j, c in enumerate(recv_rows)])
        at = sum(recv_rows[:me])
        return torch.cat([got.narrow(0, 0, at), own,
                          got.narrow(0, at, got.shape[0] - at)])

    def forward(self, w):
        """(El, ...) logical block -> (Rl, ...) physical slots."""
        send = w.index_select(0, _longs(self.send, w.device))
        got = self._move(send, [len(v) for v in self.send_idx],
                         [len(v) for v in self.recv_pos])
        return got.index_select(0, _longs(self.inv, w.device))

    def backward(self, g, n_local: int):
        """(Rl, ...) slot gradients -> the (El, ...) logical block's, each
        expert's replicas summed in slot order."""
        rows = self._move(g.index_select(0, _longs(self.pos, g.device)),
                          [len(v) for v in self.recv_pos],
                          [len(v) for v in self.send_idx])
        # rows arrive in slot order; a replica's row adds to the earlier
        # ones of its expert (the first is copied, so one replica is the
        # slot's gradient bit for bit)
        seen, rounds = {}, []
        for k, e in enumerate(self.send):
            r = seen.get(e, 0)
            seen[e] = r + 1
            if r == len(rounds):
                rounds.append(([], []))
            rounds[r][0].append(k)
            rounds[r][1].append(e)
        out = rows.new_empty((n_local, *rows.shape[1:]))
        for r, (ks, es) in enumerate(rounds):
            es = _longs(es, g.device)
            part = rows.index_select(0, _longs(ks, g.device))
            if r == 0:
                out.index_copy_(0, es, part)
            else:
                out.index_copy_(0, es, out.index_select(0, es) + part)
        return out


def _longs(values, device):
    return torch.tensor(values, dtype=torch.long, device=device)


class _PlacedWeights(torch.autograd.Function):
    """This rank's physical slots of an expert weight (``_SlotExchange``);
    the backward sends each slot's gradient home and sums replicas."""

    @staticmethod
    def forward(ctx, w, xchg):
        ctx.xchg, ctx.n = xchg, w.shape[0]
        return xchg.forward(w)

    @staticmethod
    def backward(ctx, g):
        return ctx.xchg.backward(g.contiguous(), ctx.n), None


def _replicated_body(x, wg, w1, w3, w2, info):
    """All-reduce-based MoE for tiny token counts (decode with fewer tokens
    a rank than MP ranks): tokens stay replicated, each rank computes its
    local experts masked by the routing, and a psum over (EP, ESP)
    assembles the output (the JAX function, ported)."""
    El = w1.shape[0]
    gate = info.gate
    logits = x.float() @ wg.float()
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k breaks ties toward the lower index: a stable sort
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, eidx = srt.values[:, :gate.top_k], srt.indices[:, :gate.top_k]
    if gate.normalize_topk:
        gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)
    ep_idx = coll.axis_index(info.ep_axes)
    gids = ep_idx * El + torch.arange(El, device=x.device)     # (El,)
    sel = (eidx[:, :, None] == gids[None, None, :]).to(x.dtype)
    wsel = torch.einsum("sk,ske->se", gate_w.to(x.dtype), sel)  # (S, El)
    xb = x[None].expand(El, *x.shape)                           # (El, S, M)
    h = executor.expert_ffn(xb, w1, w3, w2, info)               # partial
    y = torch.einsum("esm,se->sm", h, wsel)
    red = tuple(dict.fromkeys(info.ep_axes + info.esp_axes))
    y = coll.psum(y, red, info.n_ep * info.n_esp)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"aux_loss": zero, "z_loss": zero, "drop_frac": zero}
    return y, aux


def _mesh_call(x, params, cfg, mesh, dims, schedule, perf_model, infer,
               replicated=False):
    """``apply_moe`` on ``mesh``: the JAX ``apply_moe``'s resolution, done
    here, and its shard_map body on this rank's blocks, returned as a
    call that runs it (every collective of the layer is in the call; the
    measured calibration resolves every candidate before any rank runs
    one).  ``replicated``: ``x`` is the whole pool on every rank."""
    b, L, M = x.shape
    sizes = dims.sizes(mesh)
    n_ep, n_esp, n_mp = sizes["ep"], sizes["esp"], sizes["mp"]
    gate_cfg = cfg.gate_config()
    if n_ep > 1 and cfg.n_experts % n_ep:
        raise ValueError(f"E={cfg.n_experts} not divisible by EP={n_ep}")
    if n_esp > 1 and cfg.d_ff % n_esp:
        raise ValueError(f"d_ff={cfg.d_ff} not divisible by ESP={n_esp}")
    if replicated and torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("apply_moe(replicated=True) has no backward")
    batch_ax = tuple(dims.batch_axes)
    n_batch = axis_size(mesh, batch_ax)
    nonbatch = tuple(a for a in mesh.axis_names if a not in batch_ax)
    n_nonbatch = axis_size(mesh, nonbatch)
    B = b if replicated else b * n_batch
    tokens_global = B * L

    sched = schedule or cfg.schedule
    seqpar = sched in ("s1_seqpar", "s1_seqpar_pipe")
    token_shard = batch_ax + (tuple(dims.mp) if seqpar else ())
    n_token_shard = axis_size(mesh, token_shard)
    s_local, cap = shard_pool_capacity(tokens_global, n_token_shard, n_mp,
                                       gate_cfg, infer=infer)
    divisible = (tokens_global % max(n_token_shard, 1) == 0
                 and (seqpar or s_local % max(n_mp, 1) == 0)
                 and s_local > 0)
    use_fallback = (not divisible) or s_local < n_mp

    comm = cfg.comm or CommConfig()
    if use_fallback:
        sched, n_chunks = "dense_decode", max(cfg.pipeline_chunks, 1)
        wire = comm.wire_dtype
        wire = autosched.clamp_wire("f32" if wire == "auto" else wire)
    else:
        sched, n_chunks, wire = resolve_schedule(
            cfg, sched, B=B, L=L, infer=infer, perf_model=perf_model,
            device=x.device, n_ep=n_ep, n_esp=n_esp, n_mp=n_mp,
            n_token_shard=n_token_shard, mesh=mesh, dims=dims)
        if (schedule or cfg.schedule) == "auto" or comm.wire_dtype == "auto":
            _check_agreed(mesh, (cfg, schedule, B, L, infer,
                                 id(perf_model)),
                          sched, n_chunks, wire, x.device)

    pl = resolve_placement(cfg, n_ep, use_fallback, infer)
    info = MoEShardInfo(
        ep_axes=tuple(dims.ep), esp_axes=tuple(dims.esp),
        mp_axes=tuple(dims.mp), n_ep=n_ep, n_esp=n_esp, n_mp=n_mp,
        tokens=s_local, cap=cap, gate=gate_cfg, act=cfg.act, glu=cfg.glu,
        saa_chunks=cfg.saa_chunks, pipeline_chunks=n_chunks,
        kernel=cfg.kernel,
        comm=CommConfig(wire_dtype=wire, scaling=comm.scaling),
        placement=pl)
    pspecs = moe_param_specs(cfg, mesh, dims)
    xchg = None if pl is None else _SlotExchange(pl, mesh.group(dims.ep))

    def run():
        xt = x.reshape(b * L, M)
        if not replicated:
            xt = _boundary_in(xt, P(batch_ax or None, None), mesh, dims)
        ws = {k: _boundary_in(params[k], pspecs[k], mesh, dims)
              for k in ("wg", "w1", "w2", "w3") if params.get(k) is not None}
        if xchg is not None:
            # this rank's physical slots' experts (after the boundary: the
            # slots' gradients come home summed, then the boundary sums
            # over the replicated axes, as JAX's take precedes its
            # shard_map)
            ws.update({k: xchg(ws[k]) for k in ("w1", "w2", "w3")
                       if k in ws})
        with coll.bound(mesh):
            if replicated:
                if not use_fallback:   # this rank's block of the pool
                    xt = coll.mp_split(xt, token_shard, n_token_shard, axis=0)
            elif use_fallback:     # the whole pool on every rank
                xt = coll.mp_all_gather(xt, batch_ax, n_batch, axis=0)
            elif seqpar:           # this rank's MP slice of the rows
                xt = coll.mp_split(xt, dims.mp, n_mp, axis=0)
            y, gaux = _run_body(sched, xt, ws, cfg, info)
            if replicated:
                if not use_fallback:   # the pool's output on every rank
                    y = coll.mp_all_gather(y, token_shard, n_token_shard,
                                           axis=0)
            elif use_fallback:
                y = coll.mp_split(y, batch_ax, n_batch, axis=0)
            elif seqpar:
                y = coll.mp_all_gather(y, dims.mp, n_mp, axis=0)
            routed = gaux.get("routed", torch.zeros(
                (cfg.n_experts,), dtype=torch.float32, device=x.device))
            every = tuple(mesh.axis_names)
            load = coll.pmean(routed, every, mesh.size)
        y = _boundary_out(y.reshape(b, L, M).to(x.dtype), n_nonbatch)
        if cfg.n_shared_experts:
            sharded = pspecs["shared_w1"][1] is not None
            y = y + _shared_experts(x, params,
                                    mesh.group(dims.mp) if sharded else None)
        aux = {k: _boundary_out(gaux[k], mesh.size)
               for k in ("aux_loss", "z_loss", "drop_frac")}
        aux["expert_load"] = load
        return y, aux

    return run
