"""Host time of the MoE layer's overlapped issue against its serial twin,
across ranks.

    PYTHONPATH=src python -m repro_torch.launch.overlap_times [--pairs 12]
        [--cases s1x1,s1gx1,s1x2,s2x1,s2hx2] [--tokens 1024]
        [--device cpu]

gpt2-moe's MoE layer (d_model 768, E=8, top-2, factor E / k = 4) on
``B x tokens`` global tokens (B = 8) is run forward and backward on four
gloo ranks of the merged (data=2, model=2) mesh, all on ``cuda:0`` (one
card: NCCL refuses two ranks on one card) or, with ``--device cpu``, on
the CPU.  For each case (``<schedule>x<pipeline chunks>``) every rank runs
one warm-up of each issue mode, then ``--pairs`` pairs of the overlapped
issue (``executor.execute``'s default) and the serial one
(``executor.serial_issue``), the order alternating from pair to pair, in
one process, so the host's state is shared by both modes.  Each run is
timed on the host's clock, the device synchronised before and after.
Per rank and case it prints the medians and quartiles of both modes and
how many pairs the overlapped issue won.  Random weights from a seed.
"""

from __future__ import annotations

import argparse

CASES = ("s1x1", "s1gx1", "s1x2", "s2x1", "s2hx2")


def _rank(rank, cases, pairs, tokens, device):
    import contextlib
    import dataclasses
    import time

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import executor
    from repro_torch.core.collectives import CommConfig
    from repro_torch.core.moe import (apply_moe, init_moe_params,
                                      moe_param_specs)
    from repro_torch.launch.common import resolve_device
    from repro_torch.parallel.mesh import ParallelDims, make_mesh
    from repro_torch.parallel.sharding import P, local_shard
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    mesh = make_mesh((2, 2), ("data", "model"))
    dims = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
    m = get_config("gpt2-moe").moe
    base = dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k,
                               comm=CommConfig())
    g = torch.Generator().manual_seed(12)
    full = init_moe_params(g, base)
    x_all = torch.randn((8, tokens, base.d_model), generator=g)
    specs = moe_param_specs(base, mesh, dims)
    x0 = local_shard(x_all, P(dims.batch_axes, None, None), mesh).to(dev)
    ps = {k: local_shard(v, specs[k], mesh).to(dev) for k, v in full.items()}

    def one(cfg, serial):
        p = {k: v.clone().requires_grad_() for k, v in ps.items()}
        x = x0.clone().requires_grad_()
        sync()
        t0 = time.perf_counter()
        with (executor.serial_issue() if serial
              else contextlib.nullcontext()):
            y, _ = apply_moe(x, p, cfg=cfg, mesh=mesh, dims=dims)
            torch.autograd.grad(y.square().sum(), [x, *p.values()])
        sync()
        return (time.perf_counter() - t0) * 1e3

    out = {}
    for case in cases:
        sched, chunks = case.split("x")
        cfg = dataclasses.replace(base, schedule=sched,
                                  pipeline_chunks=int(chunks))
        one(cfg, False)
        one(cfg, True)
        ov, se = [], []
        for i in range(pairs):
            for serial in ((True, False) if i % 2 else (False, True)):
                (se if serial else ov).append(one(cfg, serial))
        out[case] = (ov, se)
    return out


def _quartiles(v):
    import numpy as np
    return np.percentile(v, 25), np.median(v), np.percentile(v, 75)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated <schedule>x<pipeline chunks>")
    ap.add_argument("--tokens", type=int, default=1024,
                    help="sequence length of the 8-row global batch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from repro_torch.launch.common import resolve_device
    from repro_torch.launch.mesh import spawn
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    cases = [c for c in args.cases.split(",") if c]
    res = spawn(_rank, 4, cases, args.pairs, args.tokens, args.device,
                backend="gloo", device=dev.type,
                threads=1 if dev.type == "cpu" else None)
    for case in cases:
        for rk, r in enumerate(res):
            ov, se = r[case]
            (oq1, om, oq3), (sq1, sm, sq3) = _quartiles(ov), _quartiles(se)
            won = sum(a < b for a, b in zip(ov, se))
            print(f"{case} rank {rk}: overlapped median {om:.1f} ms (q1 "
                  f"{oq1:.1f}, q3 {oq3:.1f}), serial median {sm:.1f} ms "
                  f"(q1 {sq1:.1f}, q3 {sq3:.1f}); overlapped faster in "
                  f"{won} of {len(ov)} pairs", flush=True)
    return res


if __name__ == "__main__":
    main()
