"""The autoscheduler's process-wide wire ceiling (counterpart of the wire
part of ``repro/core/autosched.py``): the guard rails' fp8 overflow
fallback raises every resolved wire dtype to at least ``bf16`` through
:func:`set_wire_ceiling`, and ``core/moe.py`` applies :func:`clamp_wire`
where the JAX ``apply_moe`` does.

The rest of the JAX module (``decide``, ``measure_candidates``, the
decision cache and the AlphaBeta fits) waits for the port of the cost
model; until then ``schedule="auto"`` is the JAX decision at one rank
(``core/moe.py``'s ``AUTO_AT_ONE_RANK``) and no decision is cached, so
:func:`invalidate` drops none.
"""

from __future__ import annotations

#: bytes per element of each wire format (``repro/core/perfmodel.py``'s
#: constant, copied)
WIRE_BYTES = {"f32": 4.0, "bf16": 2.0, "fp8_e4m3": 1.0}

_WIRE_CEILING = None


def set_wire_ceiling(wire) -> None:
    """Clamp every *resolved* wire decision to at least ``wire`` bytes
    per element (None clears).  ``apply_moe`` applies the clamp via
    :func:`clamp_wire`, so one ``set_wire_ceiling("bf16")`` swaps every
    fp8 wire in the model to bf16 from the next call on — the guard
    rails' fp8 overflow fallback — without touching configs or
    restarting (PyTorch runs eagerly: nothing to retrace)."""
    global _WIRE_CEILING
    if wire is not None and wire not in WIRE_BYTES:
        raise ValueError(f"unknown wire dtype {wire!r} "
                         f"(want one of {tuple(WIRE_BYTES)})")
    _WIRE_CEILING = wire


def wire_ceiling():
    return _WIRE_CEILING


def clamp_wire(wire: str) -> str:
    """Apply the process-wide wire ceiling to a resolved wire dtype:
    dtypes narrower than the ceiling are widened to it, wider ones pass
    through untouched."""
    if _WIRE_CEILING is None or wire not in WIRE_BYTES:
        return wire
    if WIRE_BYTES[wire] < WIRE_BYTES[_WIRE_CEILING]:
        return _WIRE_CEILING
    return wire


def invalidate(reason: str = "") -> int:
    """The JAX module's decision-cache invalidation: returns the number of
    cached decisions dropped, always 0 here (no decision is cached)."""
    return 0
