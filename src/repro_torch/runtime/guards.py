"""Training guard rails: non-finite skip-step, LR backoff, loss-spike
detection, and fp8 wire-overflow fallback (counterpart of
``repro/runtime/guards.py``; the host policy is a copy).

The device side lives in ``train.loop.make_guarded_train_step`` (the
update is skipped when the loss or the grad norm goes non-finite); this
module owns the HOST-side policy around it:

  * :class:`GuardState` — per-run state machine.  Every step's
    ``(loss, nonfinite)`` observation returns an action: ``OK`` (apply),
    ``SKIP`` (the step already kept the old params; back the LR off), or
    ``ROLLBACK`` (the consecutive-skip streak or the loss-spike detector
    fired — re-anchor to the last good checkpoint).
  * Loss-spike detection — rolling median + MAD over the recent finite
    losses; a loss further than ``spike_z`` robust sigmas above the
    median marks the run poisoned even though every value is finite.
  * fp8 wire-overflow fallback — the encode path in
    ``core.collectives`` counts saturating elements into a process-wide
    accumulator (enabled here); when the observed saturation rate
    crosses ``fp8_sat_threshold`` the trainer swaps every fp8 wire to
    ``fp8_fallback`` via ``autosched.set_wire_ceiling``.  PyTorch runs
    eagerly, so the next step takes the wider wire with no retrace.

Where JAX's encode reports each count to the host through
``jax.debug.callback``, the port's adds each encode's count to an int64
tensor on the encode's device, with no sync; the count reaches the host
counters only when :func:`fp8_sat_counts` (or ``check_fp8``) reads it,
once per guarded step.  With a telemetry sink installed each encode's
count also waits on the card beside its (total, event context), and the
same read emits one ``fp8_sat`` event per encode that saturated: JAX's
events, with no sync per encode.

On a mesh of ranks each rank's encodes count its own shards, where
JAX's callback under ``shard_map`` fires once per device and so counts
the world's.  The monitor installed with the mesh
(``enable_fp8_monitor(mesh, device)``) keeps each encode's count on the
card, and :func:`fold_fp8` all-gathers every rank's vector of them (the
ranks run the same encodes in the same order, which the fold checks
first): the host counters hold the world's ``(sat, total)`` on every
rank, so every rank takes the fp8 fallback at the same step and their
collectives keep one size; rank 0, which alone holds a sink, emits one
``fp8_sat`` event per rank and encode that saturated, with its ``rank``
(and rank 0's event context: the encodes are the same).

All of it is opt-in: with ``guards=None`` the Trainer runs the plain
step function, and consults this module only with a sink installed, for
the ``fp8_sat`` events.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from repro_torch import obs
from repro_torch.obs.registry import Histogram

OK = "ok"
SKIP = "skip"
ROLLBACK = "rollback"


@dataclass(frozen=True)
class GuardConfig:
    """Knobs for the training guard rails (see module docstring).

    ``max_skips``: consecutive non-finite skip-steps before a rollback
    is requested.  ``lr_backoff`` multiplies the LR scale on every skip;
    ``lr_recover`` multiplies it back up (capped at 1.0) on every clean
    step.  The spike detector needs ``spike_min`` finite losses of
    history and fires at ``spike_z`` robust sigmas (median + MAD) above
    the rolling median.  ``fp8_sat_threshold`` is the fraction of
    saturating fp8 wire elements that triggers the ``fp8_fallback``
    wire-dtype swap.
    """

    max_skips: int = 3
    lr_backoff: float = 0.5
    lr_recover: float = 1.5
    spike_window: int = 32
    spike_min: int = 8
    spike_z: float = 10.0
    fp8_sat_threshold: float = 1e-3
    fp8_fallback: str = "bf16"

    def __post_init__(self):
        if self.max_skips < 1:
            raise ValueError("max_skips must be >= 1")
        if not 0.0 < self.lr_backoff <= 1.0:
            raise ValueError("lr_backoff must be in (0, 1]")


@dataclass
class GuardState:
    """Mutable per-run guard state: streaks, LR scale, counters, and an
    event log (``events`` is what the launchers print)."""

    cfg: GuardConfig = field(default_factory=GuardConfig)
    lr_scale: float = 1.0
    streak: int = 0
    counters: dict = field(default_factory=lambda: {
        "steps": 0, "skipped": 0, "rollbacks": 0, "loss_spikes": 0,
        "fp8_fallbacks": 0, "rollback_unavailable": 0})
    events: list = field(default_factory=list)
    _losses: Histogram = None

    def __post_init__(self):
        # rolling finite-loss window: the obs histogram is the one
        # quantile codepath (median == sorted[n // 2])
        self._losses = Histogram("guard_loss",
                                 window=self.cfg.spike_window)

    # --- per-step policy -----------------------------------------------------
    def observe(self, step: int, loss: float, nonfinite: bool) -> str:
        """Fold one step's outcome in; returns OK / SKIP / ROLLBACK."""
        self.counters["steps"] += 1
        if nonfinite or not math.isfinite(loss):
            self.counters["skipped"] += 1
            self.streak += 1
            self.lr_scale = max(self.lr_scale * self.cfg.lr_backoff, 1e-4)
            self.events.append({"step": step, "kind": "skip",
                                "streak": self.streak,
                                "lr_scale": self.lr_scale})
            if self.streak >= self.cfg.max_skips:
                return ROLLBACK
            return SKIP
        if self._is_spike(loss):
            self.counters["loss_spikes"] += 1
            self.events.append({"step": step, "kind": "loss_spike",
                                "loss": loss})
            return ROLLBACK
        self.streak = 0
        self.lr_scale = min(self.lr_scale * self.cfg.lr_recover, 1.0)
        self._losses.add(loss)
        return OK

    def _is_spike(self, loss: float) -> bool:
        """Rolling median + MAD outlier test (spiking losses are never
        folded into the window, so one spike cannot mask the next)."""
        if len(self._losses) < self.cfg.spike_min:
            return False
        sigma = 1.4826 * max(self._losses.mad(), 1e-12)
        return loss > self._losses.median() + self.cfg.spike_z * sigma

    # --- rollback bookkeeping ------------------------------------------------
    def record_rollback(self, step: int, restored_step) -> None:
        """A rollback happened (or was needed but unavailable): reset the
        streak and the spike window — the restored state's losses belong
        to a different trajectory."""
        self.streak = 0
        self._losses.reset()
        if restored_step is None:
            self.counters["rollback_unavailable"] += 1
            self.events.append({"step": step, "kind": "rollback_unavailable"})
        else:
            self.counters["rollbacks"] += 1
            self.events.append({"step": step, "kind": "rollback",
                                "restored_step": restored_step})

    # --- fp8 wire-overflow fallback ------------------------------------------
    def check_fp8(self) -> bool:
        """True exactly once: when the observed fp8 wire saturation rate
        crosses the threshold (and a fallback hasn't already fired)."""
        if self.counters["fp8_fallbacks"]:
            return False
        rate = fp8_sat_rate()
        if rate > self.cfg.fp8_sat_threshold:
            self.counters["fp8_fallbacks"] += 1
            self.events.append({"kind": "fp8_fallback", "sat_rate": rate,
                                "wire": self.cfg.fp8_fallback})
            return True
        return False

    def summary(self) -> str:
        c = self.counters
        return (f"guards: {c['steps']} steps, {c['skipped']} skipped, "
                f"{c['rollbacks']} rollbacks, {c['loss_spikes']} loss "
                f"spikes, {c['fp8_fallbacks']} fp8 fallbacks, "
                f"lr_scale {self.lr_scale:.3g}")


# --- fp8 saturation accumulator ----------------------------------------------
# ``collectives.wire_encode`` (fp8 path) hands each encode's saturating
# count (a 0-d int64 tensor on the encode's device) and its element count
# (a Python int) to the installed monitor.  The device counts wait in one
# int64 tensor per device until a reader folds them into ``_SAT``; with a
# sink installed, each encode's count also waits in ``_SAT_EVENTS``.

_SAT = {"sat": 0, "total": 0}
_SAT_DEVICE = {}                 # torch.device -> 0-d int64 tensor
_SAT_EVENTS = []                 # (0-d int64 tensor, total, event context)
#: on a mesh: the AxisGroup of every rank and the device of its
#: agreement collective; None and None on one rank
_WORLD = {"group": None, "device": None}


def _sat_cb(sat, total: int) -> None:
    if _WORLD["group"] is not None:
        _SAT_EVENTS.append((sat, int(total), obs.event_context()
                            if obs.enabled() else {}))
        return
    acc = _SAT_DEVICE.get(sat.device)
    if acc is None:
        _SAT_DEVICE[sat.device] = sat.clone()
    else:
        acc.add_(sat)
    _SAT["total"] += int(total)
    if obs.enabled():
        _SAT_EVENTS.append((sat, int(total), obs.event_context()))


def fold_fp8() -> None:
    """Move the device-side counts into the host counters (one sync per
    device) and emit the pending ``fp8_sat`` events (one more read), in
    encode order, each with the context its encode ran under.  Nothing
    pending costs no sync.  On a mesh every rank must call it at the same
    point: it gathers the world's counts (see the module docstring)."""
    if _WORLD["group"] is not None:
        return _fold_world(_WORLD["group"], _WORLD["device"])
    for acc in _SAT_DEVICE.values():
        _SAT["sat"] += int(acc.item())
    _SAT_DEVICE.clear()
    if _SAT_EVENTS:
        pending = list(_SAT_EVENTS)
        _SAT_EVENTS.clear()
        sats = torch.stack([s for s, _, _ in pending]).tolist()
        for n, (_, total, ctx) in zip(sats, pending):
            if n:
                obs.emit("fp8_sat", sat=n, total=total, **ctx)


def _fold_world(grp, device) -> None:
    """``fold_fp8`` on a mesh: one all-gather of every rank's (count,
    total) per encode, after one that holds the ranks to the same number
    of encodes."""
    from repro_torch.parallel import comm
    pending = list(_SAT_EVENTS)
    _SAT_EVENTS.clear()
    comm.agree([len(pending)], grp, "the number of fp8 encodes", device)
    if not pending:
        return
    counts = torch.stack([s for s, _, _ in pending]).to(torch.int64)
    totals = torch.tensor([t for _, t, _ in pending], dtype=torch.int64,
                          device=counts.device)
    world = comm.all_gather(torch.stack([counts, totals], dim=1), grp, 0,
                            tiled=False).cpu()            # (ranks, n, 2)
    _SAT["sat"] += int(world[..., 0].sum())
    _SAT["total"] += int(world[..., 1].sum())
    if obs.enabled():
        for i, (_, _, ctx) in enumerate(pending):
            for rank, (n, total) in enumerate(world[:, i].tolist()):
                if n:
                    obs.emit("fp8_sat", sat=n, total=total, rank=rank,
                             **ctx)


def enable_fp8_monitor(mesh=None, device=None) -> None:
    """Install the saturation counter into the fp8 wire-encode path; with
    no monitor installed the encode counts nothing.  On ``mesh`` (more
    than one rank; ``device`` this rank's) the counts become the world's
    when folded."""
    from repro_torch.core import collectives
    multi = mesh is not None and mesh.size > 1
    _WORLD["group"] = mesh.group(mesh.axis_names) if multi else None
    _WORLD["device"] = device if multi else None
    collectives.set_fp8_monitor(_sat_cb)


def disable_fp8_monitor() -> None:
    from repro_torch.core import collectives
    collectives.set_fp8_monitor(None)
    _WORLD["group"] = _WORLD["device"] = None


def reset_fp8_counter() -> None:
    _SAT_DEVICE.clear()
    _SAT_EVENTS.clear()
    _SAT["sat"] = _SAT["total"] = 0


def fp8_sat_counts() -> tuple:
    fold_fp8()
    return _SAT["sat"], _SAT["total"]


def fp8_sat_rate() -> float:
    sat, total = fp8_sat_counts()
    return sat / total if total else 0.0
