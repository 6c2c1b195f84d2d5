"""Predicted-vs-measured schedule audits, the part without the cost model
(counterpart of ``repro/obs/audit.py``).

:func:`trace_schedule` runs the stage-timing harness
(:mod:`repro_torch.obs.trace`) on one schedule's plan over a layer laid
out exactly as ``apply_moe`` lays it out on one rank; :func:`audit_report`
joins a measured :class:`StageTrace` against per-stage predictions and
ranks the worst offenders by relative error (a pure join: the JAX
report's schema, field for field).

``run_schedule_audit`` and its ``tpu_v5e_model`` default need the cost
model (``core/perfmodel.py``), which comes with the autoscheduler's slice
of the port; so do the predictions a report joins against.
"""

from __future__ import annotations

import torch

from repro_torch.core.moe import MoEConfig, init_moe_params, layer_info
from repro_torch.obs.trace import StageTrace, time_plan_stages


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
