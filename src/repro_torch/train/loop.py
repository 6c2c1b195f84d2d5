"""The train steps and the loop that runs them (counterpart of
``make_train_step``, ``make_guarded_train_step`` and ``Trainer`` in
``repro/train/loop.py``), on one device.

``Trainer(guards=...)`` runs the fault-tolerant loop: the guarded step
(skip-step and LR backoff), retained-checkpoint rollback through
``ckpt_path``, the fp8 wire-overflow fallback and the ``faults``
injection hooks.  With a telemetry sink installed (``repro_torch.obs``)
both loops set the runtime context's ``step`` and emit one ``train_step``
event per history row, the guarded loop its ``guard_skip``,
``guard_rollback`` and ``fp8_fallback`` events, and both the fp8 encodes'
``fp8_sat`` events, as the JAX loop does; every field is a value the loop
already holds on the host.  Not here yet (a later slice): load-adaptive
rebalancing and its ``expert_load`` events.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.models.model import Model
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     leaves)
from repro_torch.runtime import guards as guardlib


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    schedule: Optional[str] = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: loss, gradients of every parameter, one AdamW update in
    place.  Metrics are the loss's (``ce``, ``aux``, ``ppl_proxy``,
    ``expert_load``) plus ``grad_norm``, ``lr`` and ``loss``, as tensors."""
    def train_step(params, opt_state, batch):
        flat = leaves(params)
        for t in flat:
            t.requires_grad_(True)
        loss, metrics = model.loss(params, batch, schedule=schedule)
        grads = torch.autograd.grad(loss, flat)
        om = adamw_update(params, grads, opt_state, opt_cfg)
        del grads
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **om, "loss": loss.detach()}
    return train_step


def make_guarded_train_step(model: Model, opt_cfg: AdamWConfig,
                            schedule: Optional[str] = None):
    """``make_train_step`` wrapped in guard rails: ``step(params,
    opt_state, batch, lr_scale, grad_fault)``.

    ``lr_scale`` (a float: the guard rails' LR backoff) multiplies the
    scheduled LR inside ``adamw_update``; ``grad_fault`` (a float: fault
    injection) seeds the loss as ``loss * (1 + grad_fault)``, so every
    gradient comes out scaled by ``1 + grad_fault`` through the chain
    rule; 0.0 is the exact identity and NaN / inf poisons every gradient.
    The reported loss is that product, as in JAX.  When the loss or the
    global grad norm is non-finite the update is skipped before it
    touches a leaf, so parameters, both moments and the step counter stay
    bitwise as they were; metrics gain a ``nonfinite`` flag that the
    host-side policy (``runtime.guards``) folds into its decision.  On
    the clean path (``lr_scale=1.0, grad_fault=0.0``) every extra op is
    an IEEE identity, so the step is bitwise the plain one."""
    def train_step(params, opt_state, batch, lr_scale, grad_fault):
        flat = leaves(params)
        for t in flat:
            t.requires_grad_(True)
        loss, metrics = model.loss(params, batch, schedule=schedule)
        loss = loss * (1.0 + grad_fault)
        grads = torch.autograd.grad(loss, flat)
        loss = loss.detach()
        om = adamw_update(params, grads, opt_state, opt_cfg,
                          lr_scale=lr_scale, finite=torch.isfinite(loss))
        del grads
        finite = om.pop("finite")
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **om, "loss": loss,
                                   "nonfinite": ~finite}
    return train_step


@dataclass
class Trainer:
    """End-to-end training loop (used by ``launch/train.py``).

    ``guards`` (a :class:`repro_torch.runtime.guards.GuardConfig`) opts
    into the fault-tolerant loop (``run`` -> ``_run_guarded``): the
    guarded step, retained-checkpoint rollback through ``ckpt_path``
    (kept to ``ckpt_retain`` files), the fp8 wire-overflow fallback, and
    the ``faults`` (a :class:`repro_torch.runtime.faults.FaultPlan`)
    injection hooks.  The guard state and the fp8 monitor are made here,
    not in ``setup``, so a caller that brings its own parameters gets
    them too.  With ``guards=None`` (default) the loop is the plain one.
    """
    model: Model
    opt_cfg: AdamWConfig
    schedule: Optional[str] = None
    ckpt_path: Optional[str] = None
    guards: Optional[guardlib.GuardConfig] = None
    faults: Optional[object] = None       # runtime.faults.FaultPlan
    ckpt_retain: int = 3

    def __post_init__(self):
        self.train_step = make_train_step(self.model, self.opt_cfg,
                                          self.schedule)
        self.guard_state = None
        if self.guards is not None:
            self.guard_state = guardlib.GuardState(cfg=self.guards)
            guardlib.reset_fp8_counter()
            guardlib.enable_fp8_monitor()
            factor = self.faults.fp8_sat_factor() if self.faults else 0.0
            if factor:
                from repro_torch.core import collectives
                collectives.set_fp8_sat_injection(factor)
            self.guarded_step = make_guarded_train_step(
                self.model, self.opt_cfg, self.schedule)

    def setup(self, generator):
        """Random parameters from ``generator`` and fresh AdamW state.
        Also notes the autoscheduler's decisions made before this run, so
        step 0 reports only this run's."""
        from repro_torch.core import autosched
        params = self.model.init(generator)
        self._sched_keys = set(autosched.cache_info())
        return params, adamw_init(params)

    def _log_step0(self, metrics):
        # the first step ran the model: any schedule="auto" MoE layers
        # have made their (schedule, n_chunks, wire) decisions now
        from repro_torch.core import autosched
        summary = autosched.cache_summary(
            exclude=getattr(self, "_sched_keys", ()))
        if summary:
            print(summary, flush=True)
        el = metrics.get("expert_load")
        if el is not None and el.dim() == 1 and el.shape[-1]:
            vals = " ".join(f"{float(c):.0f}" for c in el.cpu())
            print(f"expert load (routed rows/expert, all layers): [{vals}]",
                  flush=True)

    def _emit_train_step(self, m):
        """One ``train_step`` event per history row: the streaming twin of
        ``history``."""
        obs.emit("train_step", **m)

    def _log(self, m):
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"ce {m['ce']:.4f}  gnorm {m['grad_norm']:.3f}  "
              f"lr {m['lr']:.2e}", flush=True)

    def run(self, params, opt_state, data, n_steps: int, log_every: int = 10,
            ckpt_every: int = 0):
        """``n_steps`` steps on ``data.tensors(step, device)``.  Returns
        ``(params, opt_state, history)``; history holds the scalar metrics
        of every logged step (every ``log_every``-th and the last), with
        ``step`` and ``wall_s``.  With ``ckpt_path`` and ``ckpt_every``,
        every ``ckpt_every``-th step (but step 0) is saved there under
        ``{"params", "opt"}``, as the JAX loop saves it."""
        if self.guards is not None:
            return self._run_guarded(params, opt_state, data, n_steps,
                                     log_every, ckpt_every)
        history = []
        dev = self.model.device
        # with a sink, the fp8 encodes' saturation counts wait on the card
        # and are read on the logged rows, where the loop reads anyway
        sat_events = obs.enabled()
        if sat_events:
            guardlib.enable_fp8_monitor()
        t0 = time.perf_counter()
        for step in range(n_steps):
            if obs.enabled():
                obs.set_context(step=step)
            batch = data.tensors(step, dev)
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         batch)
            if step == 0:
                self._log_step0(metrics)
            if step % log_every == 0 or step == n_steps - 1:
                m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
                m["step"] = step
                m["wall_s"] = time.perf_counter() - t0
                history.append(m)
                if sat_events:
                    guardlib.fold_fp8()
                self._emit_train_step(m)
                self._log(m)
            if ckpt_every and self.ckpt_path and step and \
                    step % ckpt_every == 0:
                from repro_torch.checkpoint import save_checkpoint
                save_checkpoint(self.ckpt_path,
                                {"params": params, "opt": opt_state}, step)
        if sat_events:
            guardlib.disable_fp8_monitor()
        return params, opt_state, history

    def _run_guarded(self, params, opt_state, data, n_steps: int,
                     log_every: int = 10, ckpt_every: int = 0):
        """The fault-tolerant loop: guarded step -> observe -> (apply |
        skip | rollback), snapshots on clean steps, fp8 fallback swap.
        A rollback restores the retained checkpoint in place into
        ``params`` and ``opt_state``."""
        from repro_torch.checkpoint.ckpt import CheckpointStore
        from repro_torch.core import autosched
        from repro_torch.runtime.rollback import RollbackManager

        state = self.guard_state
        mgr = self.rollback_mgr = None
        if self.ckpt_path:
            mgr = self.rollback_mgr = RollbackManager(CheckpointStore(
                self.ckpt_path, retain=self.ckpt_retain, faults=self.faults))
            # anchor before step 0: a streak in the first interval must
            # have somewhere to roll back to
            mgr.snapshot(params, opt_state, 0)

        history = []
        dev = self.model.device
        t0 = time.perf_counter()
        for step in range(n_steps):
            if obs.enabled():
                obs.set_context(step=step)
            batch = data.tensors(step, dev)
            gf = self.faults.grad_fault(step) if self.faults else 0.0
            # a skipped step returns params/opt_state untouched
            params, opt_state, metrics = self.guarded_step(
                params, opt_state, batch, state.lr_scale, gf)
            loss = float(metrics["loss"])
            # the step's fp8 counts (and events) while the loss read has
            # just waited for the device
            guardlib.fold_fp8()
            action = state.observe(step, loss, bool(metrics["nonfinite"]))
            if step == 0:
                self._log_step0(metrics)
            if action == guardlib.ROLLBACK:
                res = mgr.rollback(step, params, opt_state) \
                    if mgr is not None else None
                if res is None:
                    # nothing restorable: limp on with the backed-off LR
                    state.record_rollback(step, None)
                    obs.emit("guard_rollback", restored_step=None,
                             loss=loss)
                else:
                    params, opt_state, rstep = res
                    state.record_rollback(step, rstep)
                    obs.emit("guard_rollback", restored_step=rstep,
                             loss=loss)
                    print(f"step {step:5d}  ROLLBACK -> re-anchored to "
                          f"checkpoint step {rstep}", flush=True)
            elif action == guardlib.SKIP:
                obs.emit("guard_skip", streak=state.streak,
                         lr_scale=state.lr_scale)
                print(f"step {step:5d}  SKIPPED (non-finite, streak "
                      f"{state.streak}, lr_scale {state.lr_scale:.3g})",
                      flush=True)
            if state.check_fp8():
                # fp8 wire overflow: clamp every wire decision up to the
                # fallback dtype; the next step's MoE layers read the
                # ceiling (params/opt state untouched)
                autosched.set_wire_ceiling(state.cfg.fp8_fallback)
                n = autosched.invalidate("fp8 wire overflow fallback")
                obs.emit("fp8_fallback", sat_rate=guardlib.fp8_sat_rate(),
                         wire=state.cfg.fp8_fallback, invalidated=n)
                print(f"fp8 wire overflow (sat rate "
                      f"{guardlib.fp8_sat_rate():.2e}): falling back to "
                      f"{state.cfg.fp8_fallback} wire "
                      f"({n} cached decisions invalidated)", flush=True)
            if step % log_every == 0 or step == n_steps - 1:
                m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
                m["step"] = step
                m["wall_s"] = time.perf_counter() - t0
                m["lr_scale"] = state.lr_scale
                history.append(m)
                self._emit_train_step(m)
                self._log(m)
            if mgr is not None and ckpt_every and step and \
                    step % ckpt_every == 0 and action == guardlib.OK:
                mgr.snapshot(params, opt_state, step)
        print(state.summary(), flush=True)
        return params, opt_state, history
