"""Predicted-vs-measured schedule audits (counterpart of
``repro/obs/audit.py``).

Parm's pitch is that the alpha-beta model picks schedules *because its
per-stage estimates are right*.  The audit closes that loop: run the
stage-timing harness (:mod:`repro_torch.obs.trace`, CUDA events on the
card) on the plans ``apply_moe`` runs on one rank, join each stage's
measured time against ``PerfModel.t_plan_stages``'s itemized prediction
(:func:`audit_report`, the JAX report's schema field for field), and rank
the worst offenders by relative error.  The report's
``calibration.time_scale`` is the one-number correction that maps the
analytic total onto this card.

Stages the model prices at zero (gate, dispatch, combine, splits — the
"local is free" assumption) keep their measured time but get
``rel_err: None`` and stay out of the ``worst`` ranking; their measured
column is exactly how you falsify that assumption.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core import plan as planlib
from repro_torch.core.moe import (MoEConfig, init_moe_params, layer_info,
                                  shard_pool_capacity)
from repro_torch.core.perfmodel import MoELayerShape, PerfModel, h100_model
from repro_torch.core.pipeline import UNCHUNKED_OF
from repro_torch.obs.trace import StageTrace, time_plan_stages

DEFAULT_AUDIT_SCHEDULES = ("s1", "s2", "s1g")


def audit_report(trace: StageTrace, predicted: dict,
                 total_predicted_s: float) -> dict:
    """Pure join of a measured :class:`StageTrace` against per-stage
    predictions (``{stage_name: seconds}``): no execution, so tests can
    pin the schema without a layer."""
    stages = []
    for s in trace.stages:
        pred = float(predicted.get(s.name, 0.0))
        rel = ((s.measured_s - pred) / pred) if pred > 0.0 else None
        stages.append({"name": s.name, "kind": s.kind,
                       "predicted_s": pred, "measured_s": s.measured_s,
                       "rel_err": rel})
    worst = [st["name"] for st in
             sorted((st for st in stages if st["rel_err"] is not None),
                    key=lambda st: abs(st["rel_err"]), reverse=True)]
    scale = (trace.total_s / total_predicted_s
             if total_predicted_s > 0.0 else None)
    return {
        "schedule": trace.schedule,
        "plan": trace.plan,
        "n_stages": trace.n_stages,
        "total_predicted_s": float(total_predicted_s),
        "total_measured_s": float(trace.total_s),
        "overhead_s": float(trace.overhead_s),
        "stages": stages,
        "worst": worst,
        "calibration": {"time_scale": scale},
    }


class _LayerHarness:
    """The traced layer's operands and layout on one rank, derived the way
    ``apply_moe`` derives them (``core.moe.layer_info``), so the traced
    plans are the plans training would run.  Parameters and tokens are
    random from ``seed`` on ``device``."""

    def __init__(self, cfg: MoEConfig, tokens_global: int,
                 infer: bool = False, seed: int = 0, device="cpu"):
        self.cfg, self.infer = cfg, infer
        self.tokens = int(tokens_global)
        s_local, _ = shard_pool_capacity(self.tokens, 1, 1,
                                         cfg.gate_config(), infer=infer)
        wire = cfg.comm.wire_dtype
        self.wire = "f32" if wire == "auto" else wire
        self.shape = MoELayerShape(
            B=max(s_local, 1), L=1, M=cfg.d_model, H=cfg.d_ff,
            E=cfg.n_experts, k=cfg.top_k, f=cfg.capacity_factor, n_mp=1,
            n_esp=1, n_ep=1, infer=infer)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.params = init_moe_params(gen, cfg)
        self.x = torch.randn((self.tokens, cfg.d_model), generator=gen,
                             device=device)
        self.args = (self.x, self.params["wg"], self.params["w1"],
                     self.params.get("w3") if cfg.glu else None,
                     self.params["w2"])

    def info(self, n_chunks: int = 1):
        return layer_info(self.cfg, self.tokens, n_chunks, infer=self.infer)

    def trace(self, schedule: str, n_chunks: int = 1, iters: int = 5,
              warmup: int = 2) -> StageTrace:
        return time_plan_stages(schedule, self.info(n_chunks), self.args,
                                iters=iters, warmup=warmup,
                                n_chunks=n_chunks)


def trace_schedule(cfg: MoEConfig, tokens_global: int, schedule: str, *,
                   infer: bool = False, n_chunks: int = 1, iters: int = 5,
                   warmup: int = 2, seed: int = 0,
                   device="cpu") -> StageTrace:
    """Single-schedule stage trace (the launchers' ``--trace`` path: the
    returned :class:`StageTrace` exports via
    :func:`repro_torch.obs.trace.save_chrome_trace`)."""
    h = _LayerHarness(cfg, tokens_global, infer=infer, seed=seed,
                      device=device)
    return h.trace(schedule, n_chunks=n_chunks, iters=iters, warmup=warmup)


def run_schedule_audit(cfg: MoEConfig, tokens_global: int,
                       schedules: Sequence[str] = DEFAULT_AUDIT_SCHEDULES,
                       perf_model: Optional[PerfModel] = None,
                       n_chunks: int = 1, iters: int = 5, warmup: int = 2,
                       seed: int = 0, device="cuda") -> List[dict]:
    """Measure and price the given schedules on one rank and return one
    audit report per schedule.  ``perf_model`` defaults to the card's
    data-sheet ``h100_model(1, 1, 1)``; pass a fitted one
    (``repro_torch.launch.fit_perfmodel.fit_card_model``) to audit what
    the card's own fit predicts."""
    h = _LayerHarness(cfg, tokens_global, seed=seed, device=device)
    pm = perf_model or h100_model(1, 1, 1)
    reports = []
    for sched in schedules:
        trace = h.trace(sched, n_chunks=n_chunks, iters=iters,
                        warmup=warmup)
        base = UNCHUNKED_OF.get(sched, sched)
        plan = planlib.build_plan(base, h.info(n_chunks),
                                  n_chunks=n_chunks)
        predicted = pm.t_plan_stages(plan, h.shape, wire_dtype=h.wire)
        total_pred = pm.t_plan(plan, h.shape, wire_dtype=h.wire)
        reports.append(audit_report(trace, predicted, total_pred))
    return reports
