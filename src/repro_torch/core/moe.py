"""The MoE layer on one rank (counterpart of ``repro/core/moe.py``).

``apply_moe`` runs every schedule of the JAX package's ``SCHEDULES`` (and
any schedule registered with ``plan.register_plan``) through the ported
plan IR: ``schedules.BODY[name]`` or the ``*_pipe`` bodies build the plan
and ``executor.execute`` lowers it.  On one rank (``n_ep = n_esp = n_mp =
1``) every collective is the identity plus the wire codec, so every
schedule runs gate -> ``moe_dispatch`` -> (wire) -> ``expert_ffn`` ->
(wire) -> ``moe_combine``, and ``s1g`` the fused ``expert_ffn_grouped``
(or, on an fp8 wire, dispatch -> ``expert_ffn_ragged`` -> combine).

``schedule="auto"`` is ``s1g`` with one chunk: the JAX autoscheduler's
decision at one rank, for every serving and training shape
(``tests/test_torch_moe.py`` and ``tests/test_torch_train.py`` pin it).
``CommConfig(wire_dtype="auto")`` and ``autosched="measured"`` need the
cost model and the measured calibration, which come with a later slice:
they raise.  So does a multi-rank layout.

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

import torch

from repro_torch import obs
from repro_torch.core import autosched, executor
from repro_torch.core import plan as planlib
from repro_torch.core.collectives import CommConfig
from repro_torch.core.gating import GateConfig, capacity
from repro_torch.core.pipeline import PIPELINE_OF, UNCHUNKED_OF
from repro_torch.core.schedules import BODY, SCHEDULES, MoEShardInfo
from repro_torch.kernels.registry import KernelConfig

#: the JAX autoscheduler's (schedule, n_chunks) at one rank
AUTO_AT_ONE_RANK = ("s1g", 1)
LATER = "comes with a later slice of the port"
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
    autosched: str = "analytic"   # "auto" decision mode ("measured" raises)
    act: str = "silu"             # expert activation ("silu" | "gelu")
    kernel: KernelConfig = KernelConfig()
    comm: CommConfig = CommConfig()  # wire format: f32 | bf16 | fp8_e4m3

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
               infer: bool = False) -> MoEShardInfo:
    """The one-rank ``MoEShardInfo`` of a layer over ``tokens`` tokens, as
    ``apply_moe`` derives it (also the stage-trace harness's layout)."""
    gate_cfg = cfg.gate_config()
    s_local, cap = shard_pool_capacity(tokens, 1, 1, gate_cfg, infer=infer)
    comm = cfg.comm or CommConfig()
    return MoEShardInfo(
        ep_axes=("ep",), esp_axes=("esp",), mp_axes=("mp",), n_ep=1,
        n_esp=1, n_mp=1, tokens=s_local, cap=cap, gate=gate_cfg,
        act=cfg.act, glu=cfg.glu, saa_chunks=cfg.saa_chunks,
        pipeline_chunks=n_chunks, kernel=cfg.kernel,
        # the guard rails' wire ceiling (fp8 overflow fallback), applied
        # to the resolved wire as the JAX apply_moe applies it
        comm=CommConfig(wire_dtype=autosched.clamp_wire(comm.wire_dtype),
                        scaling=comm.scaling))


def resolve_schedule(cfg: MoEConfig, schedule=None):
    """(schedule name, n_chunks) that ``apply_moe`` runs on one rank:
    ``"auto"`` -> ``AUTO_AT_ONE_RANK``; a chunk count > 1 routes a base
    schedule to its ``*_pipe`` body, as the JAX ``apply_moe`` does."""
    sched = schedule or cfg.schedule
    n_chunks = max(cfg.pipeline_chunks, 1)
    wire = (cfg.comm or CommConfig()).wire_dtype
    if wire == "auto":
        raise NotImplementedError(
            f"wire_dtype='auto' needs the autoscheduler's cost model, which "
            f"{LATER}; pick f32, bf16 or fp8_e4m3")
    if cfg.autosched != "analytic":
        raise NotImplementedError(
            f"autosched={cfg.autosched!r} (the measured calibration) {LATER}")
    if sched == "auto":
        sched, n_chunks = AUTO_AT_ONE_RANK
    if n_chunks > 1 and sched in PIPELINE_OF:
        sched = PIPELINE_OF[sched]
    if sched not in BODY and UNCHUNKED_OF.get(sched, sched) \
            not in planlib.PLANS:
        raise KeyError(f"unknown schedule {sched!r}: not in schedules.BODY "
                       f"nor the plan registry (have "
                       f"{sorted(set(SCHEDULES) | set(planlib.PLANS))})")
    return sched, n_chunks


def apply_moe(x, params: dict, *, cfg: MoEConfig, schedule=None,
              infer: bool = False):
    """One MoE layer on one rank under the configured schedule.
    x: (B, L, M).  Returns ``(y, aux)`` with aux ``aux_loss``, ``z_loss``,
    ``drop_frac`` and ``expert_load`` (the (E,) routed rows), as the JAX
    ``apply_moe`` returns them.

    ``infer=True`` marks a decode pool (drop-free capacity); prefill
    pools (``infer=False``) take the training capacity, so padding rows of
    a prefill bucket compete for slots exactly as in the JAX engine.
    """
    B, L, M = x.shape
    sched, n_chunks = resolve_schedule(cfg, schedule)
    info = layer_info(cfg, B * L, n_chunks, infer=infer)
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
