"""Plan-stage times (counterpart of ``repro/obs/trace.py``).

For a plan with stages ``s_1..s_n`` (topo order) :func:`time_plan_stages`
runs each prefix ``[s_1..s_k]`` through :func:`executor.execute_prefix`,
which returns a scalar folding a probe of every stage output, and
charges

    measured(s_k) = median_t(prefix_k) - median_t(prefix_{k-1})

clamped at 0: JAX's definition.  On a mesh (``mesh=``) every rank runs
each prefix together, collectives included, times its own runs, and the
prefix's time is the largest of the ranks' medians: JAX times the whole
program, which ends when its slowest device does.  On the card each run
of a prefix is
timed with a pair of CUDA events on the current stream, the counterpart of
``jax.block_until_ready`` around a jitted prefix: the device time from the
first launch of the prefix to its last, with the host's launch cost in it
wherever the card waits for the host.  On the CPU (the tests) there is no
device clock, so the host clock times the call.  The full plan
(``apply_moe``'s) is never modified, so timing it cannot change outputs:
``torch.equal`` holds (``tests/test_torch_obs.py``, ``chip_smoke.py``).

A trace exports as Chrome-trace JSON (``chrome://tracing`` / Perfetto):
one ``X`` slice per stage laid end to end.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch.core import executor
from repro_torch.core import plan as planlib
from repro_torch.core.pipeline import UNCHUNKED_OF
from repro_torch.core.plan import validate


@dataclass
class StageTime:
    name: str
    kind: str
    measured_s: float


@dataclass
class StageTrace:
    """Per-stage times for one executed plan."""

    plan: str                    # full plan name (chunked variant)
    schedule: str                # base schedule name requested
    total_s: float               # median time of the full plan
    overhead_s: float            # prefix-0 program (input probe only)
    stages: List[StageTime] = field(default_factory=list)

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def by_name(self) -> dict:
        return {s.name: s for s in self.stages}


def _median_time(fn, iters: int, warmup: int, device) -> float:
    """Median seconds of ``fn()``: CUDA events on the current stream on a
    card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    ts = []
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(iters)]
        for t0, t1 in pairs:
            t0.record(stream)
            fn()
            t1.record(stream)
        torch.cuda.synchronize(device)
        ts = [t0.elapsed_time(t1) * 1e-3 for t0, t1 in pairs]
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def time_plan_stages(schedule: str, info, args, iters: int = 5,
                     warmup: int = 2, n_chunks: Optional[int] = None,
                     mesh=None) -> StageTrace:
    """Measure per-stage times of one plan on one rank, or on every rank
    of ``mesh`` (each rank calls it with its shards; every rank returns
    the same trace: each prefix's largest median over the ranks).

    ``info`` is the layer's ``MoEShardInfo``; ``args`` are the operands
    ``(xt, wg, w1, w3, w2)`` exactly as ``apply_moe`` feeds its body
    (callers: :func:`repro_torch.obs.audit.trace_schedule`, the launchers'
    ``--trace``, the tests).  Runs without autograd.
    """
    from repro_torch.core import collectives
    base = UNCHUNKED_OF.get(schedule, schedule)
    plan = planlib.build_plan(base, info, n_chunks=n_chunks)
    order = validate(plan)
    device = args[0].device
    medians = []
    with torch.no_grad(), collectives.bound(mesh):
        for k in range(len(order) + 1):
            medians.append(_median_time(
                lambda: executor.execute_prefix(plan, *args, info, k),
                iters, warmup, device))
    if mesh is not None and mesh.size > 1:
        from repro_torch.parallel import comm
        slowest = comm.pmax(torch.tensor(medians, dtype=torch.float64,
                                         device=device),
                            mesh.group(mesh.axis_names))
        medians = slowest.tolist()
    stages = [StageTime(name=st.name, kind=st.kind,
                        measured_s=max(0.0, medians[i + 1] - medians[i]))
              for i, st in enumerate(order)]
    return StageTrace(plan=plan.name, schedule=schedule,
                      total_s=medians[-1], overhead_s=medians[0],
                      stages=stages)


# --- Chrome trace export -----------------------------------------------------

def chrome_trace_events(trace: StageTrace) -> List[dict]:
    """Chrome-trace ``X`` (complete) events, one per stage, laid end to
    end on a single track.  Times in microseconds per the format."""
    events = [{"name": "process_name", "ph": "M", "pid": 0,
               "args": {"name": f"plan {trace.plan}"}},
              {"name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
               "args": {"name": trace.schedule}}]
    ts = 0.0
    for s in trace.stages:
        dur = s.measured_s * 1e6
        events.append({"name": s.name, "cat": s.kind, "ph": "X",
                       "ts": round(ts, 3), "dur": round(dur, 3),
                       "pid": 0, "tid": 0,
                       "args": {"kind": s.kind,
                                "measured_s": s.measured_s}})
        ts += dur
    return events


def save_chrome_trace(trace: StageTrace, path: str) -> str:
    with open(path, "w") as fh:
        json.dump({"traceEvents": chrome_trace_events(trace),
                   "displayTimeUnit": "ms"}, fh, indent=1)
    return path
