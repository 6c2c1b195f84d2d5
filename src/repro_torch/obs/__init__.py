"""Telemetry of the port (counterpart of ``repro/obs/__init__.py``).

  * :mod:`repro_torch.obs.registry` — counters, gauges, rolling-window
    histograms and THE quantile every p50/p95/p99 of the port goes
    through (a copy of the JAX module);
  * :mod:`repro_torch.obs.sink` — the buffered JSONL event sink with a
    run-metadata header and size-based rotation (a copy);
    ``--metrics-dir`` on the launchers installs one process-wide, and
    every emitter below writes through it;
  * :mod:`repro_torch.obs.trace` / :mod:`repro_torch.obs.audit` —
    plan-stage traces: each prefix of a plan timed with CUDA events on
    the current stream, stage k charged the difference of prefixes k and
    k - 1.

Emission is opt-in and cheap when off: ``emit(...)`` with no sink
installed is one attribute test and touches no field.  No event costs a
sync: every field is a value the host already holds (the sink refuses a
tensor on the card), and the fp8 saturation events wait on the card
until the guarded loop's one read per step (``runtime.guards``).

Two context planes keep events attributable, as in JAX:

  * runtime context (:func:`set_context`) — host-side facts such as the
    current train step, merged into every event at emit time;
  * call context (:func:`trace_tag` / :func:`trace_context`) — facts
    known only inside a call, such as which MoE layer an fp8 encode
    belongs to.  JAX captures them while tracing; PyTorch runs eagerly,
    so here they are the context of the running call (the fp8 codec's
    backward restores its forward's).
"""

from __future__ import annotations

from contextlib import contextmanager

from repro_torch.obs.registry import (Counter, Gauge, Histogram,  # noqa: F401
                                      Registry, default_registry, quantile)
from repro_torch.obs.sink import JsonlSink  # noqa: F401

_SINK = None            # process-wide JsonlSink (None = telemetry off)
_RUNTIME_CTX: dict = {}  # host-side event context (e.g. step=)
_TRACE_CTX: dict = {}    # call context (e.g. moe_call=)


def configure(metrics_dir: str, meta=None, **sink_kw) -> JsonlSink:
    """Install a process-wide JSONL sink writing under ``metrics_dir``.
    Returns it (also reachable via :func:`get_sink`)."""
    global _SINK
    if _SINK is not None:
        _SINK.close()
    _SINK = JsonlSink(metrics_dir, meta=meta, **sink_kw)
    return _SINK


def get_sink():
    return _SINK


def enabled() -> bool:
    return _SINK is not None


def emit(event: str, **fields) -> None:
    """Write one event through the installed sink (no-op when none is
    installed).  The runtime context is merged in under the event's own
    fields (explicit fields win)."""
    if _SINK is None:
        return
    if _RUNTIME_CTX:
        merged = dict(_RUNTIME_CTX)
        merged.update(fields)
        fields = merged
    _SINK.emit(event, **fields)


def flush() -> None:
    if _SINK is not None:
        _SINK.flush()


def close() -> None:
    """Flush and close the installed sink (idempotent)."""
    global _SINK
    if _SINK is not None:
        _SINK.close()
        _SINK = None
    _RUNTIME_CTX.clear()
    _TRACE_CTX.clear()


def set_context(**fields) -> None:
    """Merge host-side context (e.g. ``step=12``) into every subsequent
    :func:`emit`.  A value of None removes the key."""
    for k, v in fields.items():
        if v is None:
            _RUNTIME_CTX.pop(k, None)
        else:
            _RUNTIME_CTX[k] = v


def trace_context() -> dict:
    """Snapshot of the call context (copy; safe to keep)."""
    return dict(_TRACE_CTX)


def event_context() -> dict:
    """What an event emitted now would carry from both context planes
    (the call context over the runtime context): for an event whose
    numbers are read later, as the fp8 saturation events are."""
    return {**_RUNTIME_CTX, **_TRACE_CTX}


@contextmanager
def trace_tag(**fields):
    """Tag everything run inside the block (e.g. ``moe_call=3``) so the
    events it records carry it."""
    saved = {k: _TRACE_CTX.get(k) for k in fields}
    _TRACE_CTX.update(fields)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                _TRACE_CTX.pop(k, None)
            else:
                _TRACE_CTX[k] = v
