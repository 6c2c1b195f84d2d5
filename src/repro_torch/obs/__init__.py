"""Telemetry of the port: so far only the metrics registry (a copy of
``repro/obs/registry.py``), which the guard rails' spike detector uses."""
from repro_torch.obs.registry import (Counter, Gauge, Histogram,  # noqa: F401
                                      Registry, default_registry, quantile)
