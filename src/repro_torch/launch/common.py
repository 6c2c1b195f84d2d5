"""What the port's launchers share: the device rule and the profile."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``cuda`` (the default) must exist; ``cpu`` only when asked for.
    Switches TF32 off: the JAX reference computes in full f32."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device available; the port runs "
                         "on the card (pass --device cpu to run on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def device_profile(run, wall_ms, top=12):
    """Call ``run()`` under ``torch.profiler`` and sum device kernel time
    by kernel name and by the op that launched it.  The profiler slows the
    host many times over, so the busy share divides the device time by
    ``wall_ms``, the wall time of the same work run unprofiled.  Returns
    {wall_ms, busy_ms, busy_share, n_kernels, top, top_ops}, the last two
    lists of {name, calls, ms}; one stream, so kernel durations do not
    overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        calls, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    # the same device time attributed to the PyTorch op that launched it
    ops = sorted(((e.key, e.count, e.self_device_time_total)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda r: -r[2])[:top]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "n_kernels": sum(c for c, _ in by_name.values()),
            "top": [{"name": n, "calls": c, "ms": us / 1e3}
                    for n, (c, us) in rows],
            "top_ops": [{"name": n, "calls": c, "ms": us / 1e3}
                        for n, c, us in ops]}
