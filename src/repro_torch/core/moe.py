"""The MoE layer on one rank (counterpart of ``repro/core/moe.py``).

``apply_moe`` runs every schedule of the JAX package's ``SCHEDULES`` (and
any schedule registered with ``plan.register_plan``) through the ported
plan IR: ``schedules.BODY[name]`` or the ``*_pipe`` bodies build the plan
and ``executor.execute`` lowers it.  On one rank (``n_ep = n_esp = n_mp =
1``) every collective is the identity plus the wire codec, so every
schedule runs gate -> ``moe_dispatch`` -> (wire) -> ``expert_ffn`` ->
(wire) -> ``moe_combine``, and ``s1g`` the fused ``expert_ffn_grouped``
(or, on an fp8 wire, dispatch -> ``expert_ffn_ragged`` -> combine).

``schedule="auto"`` and ``CommConfig(wire_dtype="auto")`` resolve
through ``autosched.decide`` as in the JAX ``apply_moe``: analytically
from the cost model (``core/perfmodel.py``, the card's ``h100_model`` by
default) or, under ``autosched="measured"``, from a one-shot calibration
of every candidate on the layer's device.  At one rank the analytic
decision is ``s1g`` with one chunk on the f32 wire at every serving and
training shape (``tests/test_torch_moe.py``, ``tests/test_torch_train.py``
pin it).  A multi-rank layout raises.

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
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core import autosched, executor
from repro_torch.core import plan as planlib
from repro_torch.core.collectives import CommConfig
from repro_torch.core.gating import GateConfig, capacity
from repro_torch.core.perfmodel import MoELayerShape, PerfModel, h100_model
from repro_torch.core.pipeline import PIPELINE_OF, UNCHUNKED_OF, clamp_chunks
from repro_torch.core.schedules import BODY, SCHEDULES, MoEShardInfo
from repro_torch.kernels.registry import KernelConfig

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
                     device="cpu"):
    """(schedule name, n_chunks, wire dtype) that ``apply_moe`` runs on
    one rank for a (B, L) token pool, as the JAX ``apply_moe`` resolves
    them: ``"auto"`` (schedule or wire) asks ``autosched.decide`` for the
    layer's ``MoELayerShape`` — chunk candidates clamped to the capacity
    (one chunk for a decode pool), a forced schedule with an ``"auto"``
    wire restricting the grid to itself, a calibration on ``device``
    under ``autosched="measured"`` — then the wire ceiling applies, and a
    chunk count > 1 routes a base schedule to its ``*_pipe`` body."""
    sched = schedule or cfg.schedule
    n_chunks = max(cfg.pipeline_chunks, 1)
    wire = (cfg.comm or CommConfig()).wire_dtype
    if sched == "auto" or wire == "auto":
        s_local, cap = shard_pool_capacity(B * L, 1, 1, cfg.gate_config(),
                                           infer=infer)
        shape = MoELayerShape(
            B=max(s_local // max(L, 1), 1), L=min(L, s_local),
            M=cfg.d_model, H=cfg.d_ff, E=cfg.n_experts, k=cfg.top_k,
            f=cfg.capacity_factor, n_mp=1, n_esp=1, n_ep=1, infer=infer)
        # only chunk counts the bodies can run (scored == executed); a
        # decode pool never chunks
        cands = ((1,) if infer else
                 tuple(sorted({clamp_chunks(cap, n)
                               for n in autosched.DEFAULT_CHUNKS})))
        forced = None
        if sched != "auto":
            forced = (UNCHUNKED_OF.get(sched, sched),)
            cands = (clamp_chunks(cap, n_chunks),)
        wire_cands = autosched.AUTO_WIRE if wire == "auto" else (wire,)
        measure = (autosched.measure_candidates(
            cfg, tokens=B * L, d_model=cfg.d_model, device=device)
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


def apply_moe(x, params: dict, *, cfg: MoEConfig, schedule=None,
              perf_model: Optional[PerfModel] = None, infer: bool = False):
    """One MoE layer on one rank under the configured schedule.
    x: (B, L, M).  Returns ``(y, aux)`` with aux ``aux_loss``, ``z_loss``,
    ``drop_frac`` and ``expert_load`` (the (E,) routed rows), as the JAX
    ``apply_moe`` returns them.

    ``infer=True`` marks a decode pool (drop-free capacity); prefill
    pools (``infer=False``) take the training capacity, so padding rows of
    a prefill bucket compete for slots exactly as in the JAX engine.
    ``perf_model`` prices ``"auto"`` (default: the card's ``h100_model``).
    """
    B, L, M = x.shape
    sched, n_chunks, wire = resolve_schedule(
        cfg, schedule, B=B, L=L, infer=infer, perf_model=perf_model,
        device=x.device)
    info = layer_info(cfg, B * L, n_chunks, infer=infer, wire=wire)
    body = BODY.get(sched)
    if body is None:
        # a schedule registered via plan.register_plan without a BODY
        # alias: execute its plan directly, chunked per pipeline_chunks
        base = UNCHUNKED_OF.get(sched, sched)

        def body(xt, wg, w1, w3_, w2, info):
            return executor.execute(planlib.build_plan(base, info), xt, wg,
                                    w1, w3_, w2, info)
    xt = x.reshape(B * L, M)
    with obs.trace_tag(moe_call=_next_call(), schedule=sched,
                       wire=info.comm.wire_dtype):
        y, gaux = body(xt, params["wg"], params["w1"],
                       params.get("w3") if cfg.glu else None, params["w2"],
                       info)
    y = y.reshape(B, L, M).to(x.dtype)
    if cfg.n_shared_experts:
        h = torch.einsum("blm,mf->blf", x, params["shared_w1"])
        h = torch.nn.functional.silu(h) * torch.einsum(
            "blm,mf->blf", x, params["shared_w3"])
        y = y + torch.einsum("blf,fm->blm", h, params["shared_w2"])
    aux = {k: gaux[k] for k in ("aux_loss", "z_loss", "drop_frac")}
    aux["expert_load"] = gaux["routed"]
    return y, aux
