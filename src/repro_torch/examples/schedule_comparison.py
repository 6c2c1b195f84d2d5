"""Compare Parm's schedules on one MoE layer across ranks: numerical
equivalence, communication volume and wall time.

    PYTHONPATH=src python -m repro_torch.examples.schedule_comparison
    PYTHONPATH=src python -m repro_torch.examples.schedule_comparison \\
        --device cpu

The paper's Fig. 3 in executable form: the same math under each schedule,
with the collectives each one issues.  One layer (``d_model`` 256,
``d_ff`` 512, E=8, top-2, capacity factor 2.0) over x (8, 512, 256) on the
``(data=4, model=2)`` mesh (EP over data, ESP == MP over model): 8 gloo
ranks sharing ``cuda:0``, or on the CPU with ``--device cpu``.  Per
schedule: the collectives' result bytes and counts on one rank, counted
on the port's transport (``parallel.comm``'s timing, under XLA's HLO
names: ``comm.psum``'s reduce-scatter and AllGather are one
``all-reduce`` of the whole array, as XLA counts an AllReduce), ms a
call (CUDA events on the card, the host clock on the CPU) and
``max|y - y_base|`` over every rank's block.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace

import torch

from repro_torch.core import autosched
from repro_torch.core.moe import (MoEConfig, apply_moe, init_moe_params,
                                  moe_param_specs)
from repro_torch.launch.common import resolve_device
from repro_torch.launch.mesh import spawn
from repro_torch.parallel import comm
from repro_torch.parallel.mesh import ParallelDims, make_mesh
from repro_torch.parallel.sharding import P, local_shard

SHAPE, NAMES = (4, 2), ("data", "model")
DIMS = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
#: (label, schedule, pipeline chunks), the JAX example's rows
ROWS = (("baseline", "baseline", 1), ("s1", "s1", 1), ("s2", "s2", 1),
        ("s1_seqpar", "s1_seqpar", 1), ("s1 x4", "s1", 4),
        ("s2 x4", "s2", 4), ("auto", "auto", 1))
#: ``parallel.comm``'s collectives under XLA's HLO names
HLO_KIND = {"all_to_all": "all-to-all", "all_to_all_rows": "all-to-all",
            "all_gather": "all-gather", "psum": "all-reduce",
            "pmax": "all-reduce", "psum_scatter": "reduce-scatter",
            "permute_rows": "collective-permute"}


def layer_config(d_model=256, d_ff=512) -> MoEConfig:
    return MoEConfig(d_model=d_model, d_ff=d_ff, n_experts=8, top_k=2,
                     capacity_factor=2.0)


def volumes() -> dict:
    """The collectives timed on this rank since ``comm.timing(True)``:
    HLO kind -> {group axes: (count, result bytes)}."""
    out = {}
    calls = comm.calls_out()
    for name, groups in comm.bytes_out().items():
        kind = out.setdefault(HLO_KIND[name], {})
        for axes, nbytes in groups.items():
            c, b = kind.get(axes, (0, 0))
            kind[axes] = (c + calls[name][axes], b + nbytes)
    return out


def totals(vols: dict) -> tuple:
    """``(total bytes, {kind: count})`` of :func:`volumes`' record."""
    nbytes = sum(b for groups in vols.values() for _, b in groups.values())
    counts = {k: sum(c for c, _ in groups.values())
              for k, groups in sorted(vols.items())}
    return nbytes, counts


def _ms(call, dev, iters: int) -> float:
    """ms a call of ``call`` over ``iters`` calls: CUDA events on the card,
    the host clock on the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    return (time.perf_counter() - t0) * 1e3 / iters


def compare(mesh, dims: ParallelDims, dev, *, cfg: MoEConfig = None,
            batch: int = 8, seq: int = 512, iters: int = 5, rows=ROWS,
            seed: int = 0) -> list:
    """Every row of ``rows`` on this rank of ``mesh``: the layer's inputs
    made on the CPU from ``seed`` (the same on every rank), this rank's
    blocks moved to ``dev``.  Per row: ``label``, ``schedule``, ``chunks``,
    ``volumes`` (the first call's, :func:`volumes`), ``ms`` (over ``iters``
    more calls), ``decision`` (the autoscheduler's line, where the row made
    one) and ``err``, max |y - y_base| over every rank's block against the
    first row's output."""
    cfg = cfg or layer_config()
    g = torch.Generator().manual_seed(seed)
    params = init_moe_params(g, cfg)
    x = torch.randn((batch, seq, cfg.d_model), generator=g)
    specs = moe_param_specs(cfg, mesh, dims)
    p = {k: local_shard(v, specs[k], mesh).to(dev) for k, v in params.items()}
    xb = local_shard(x, P(dims.batch_axes, None, None), mesh).to(dev)
    out, base, errs = [], None, []
    with torch.no_grad():
        for label, sched, chunks in rows:
            c = replace(cfg, pipeline_chunks=chunks)

            def call(c=c, sched=sched):
                return apply_moe(xb, p, cfg=c, mesh=mesh, dims=dims,
                                 schedule=sched)[0]
            before = set(autosched.cache_info())
            comm.timing(True)
            try:
                y = call()
                vols = volumes()
            finally:
                comm.timing(False)
            ms = _ms(call, dev, iters)
            base = y if base is None else base
            errs.append(float((y - base).abs().max()))
            out.append({"label": label, "schedule": sched, "chunks": chunks,
                        "volumes": vols, "ms": ms,
                        "decision": autosched.cache_summary(exclude=before)})
        # the largest error over every rank's block, on every rank
        every = comm.pmax(torch.tensor(errs, dtype=torch.float64),
                          mesh.group(mesh.axis_names))
    for row, err in zip(out, every.tolist()):
        row["err"] = err
    return out


def _rank(rank, args):
    mesh = make_mesh(SHAPE, NAMES)
    dev = (torch.device("cpu") if args.device == "cpu" else
           torch.device("cuda", torch.cuda.current_device()))
    return compare(mesh, DIMS, dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = SHAPE[0] * SHAPE[1]
    res = spawn(_rank, n, args, backend="gloo", device=dev.type,
                threads=1 if dev.type == "cpu" else None)
    rows = res[0]
    print(f"{'schedule':12s} {'coll bytes':>12s} {'collectives':>54s} "
          f"{'ms/call':>8s} {'max|y-y_base|':>14s}")
    for row in rows:
        nbytes, counts = totals(row["volumes"])
        print(f"{row['label']:12s} {nbytes:12d} {str(counts):>54s} "
              f"{row['ms']:8.1f} {row['err']:14.2e}")
        if row["decision"]:
            print(f"  {row['decision']}")
    return res


if __name__ == "__main__":
    main()
