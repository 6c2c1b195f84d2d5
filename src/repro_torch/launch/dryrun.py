"""Dry run of the port: prove a distribution config is coherent before
anyone rents the cluster (counterpart of ``repro/launch/dryrun.py``).

For each architecture x input shape x mesh, the step the shape runs
(``make_train_step`` / ``make_prefill_fn`` / ``make_serve_step``) is
traced ONCE as one rank of the production mesh (16x16, or 2x16x16 with
``--mesh multi``) on the meta device, under ``torch.distributed``'s fake
backend: nothing is allocated and no data moves, the collectives return
at once, and the kernels answer through their meta rules
(``kernels/meta.py``).  The record has JAX's keys:

  * ``memory_analysis``: this rank's arguments (parameters, AdamW
    moments under ZeRO-1, the batch, and the KV cache to decode, with a
    cross-attention arch's ``ctx_kv``, an argument of JAX's step too), its
    outputs, and the temporaries (the peak of the live storage the step
    allocated), with ``fits_80gb`` beside it;
  * ``cost_flops`` / ``cost_bytes`` and ``collectives`` (counts and bytes
    by HLO kind), from ``analysis.layerwise``;
  * ``roofline``: the three terms priced at an H100 SXM's data-sheet
    figures (``analysis.roofline``; no term is a measurement);
  * the autoscheduler's pick (analytic: a measured pick needs real ranks)
    and, with ``--dump-plan``, the plan graph.

ZeRO-1 shards the moments over JAX's axes (:func:`zero_axes_for`).  JAX's
``lower_s`` / ``compile_s`` are one ``trace_s`` here, and JAX's
``hlo_lines`` and ``--save-hlo`` have no counterpart (there is no HLO).

``--run-step`` (``--guards`` with it) and ``--audit`` run for real on the
test mesh's 8 ranks (4x2, or 2x2x2 with ``multi``) spawned over gloo on
``--device`` (the card by default, ``cpu`` when asked): parameters from
``Model.init`` at seed 0 on every rank cut to its shards, the ZeRO-1
moments, a batch of zeros, one optimizer step; rank 0's loss is printed
as ``[step] <arch> x <shape> sched=... wire=... loss=...``.  ``--audit``
runs ``obs.audit.run_schedule_audit`` on a 4x2 mesh of those ranks.

Artifacts land in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__<sched>][__<tag>].json``.

Usage (on the CPU: the trace needs no card):
  python -m repro_torch.launch.dryrun --arch qwen3-moe-30b-a3b --shape train_4k --mesh both
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --arch gpt2-moe --shape train_4k --reduced \\
      --seq 64 --batch 8 --run-step            # 8 ranks on the card
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
from dataclasses import replace

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.configs import (ASSIGNED, INPUT_SHAPES, get_config,
                                 variant_config)

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")
#: an H100 80GB's memory, in bytes, as the name states it
HBM_BYTES = 80e9
#: ranks of the test mesh (``--run-step``, ``--audit``)
TEST_RANKS = 8


def moe_pool_cap(cfg, shape, sizes, nb, sched_name):
    """This rank's token pool and capacity exactly as ``apply_moe``
    computes them (``moe.shard_pool_capacity``; the seqpar contract adds
    the MP axes to the token shard); decode shapes take the drop-free
    capacity.  JAX's ``_moe_pool_cap``."""
    from repro_torch.core.moe import shard_pool_capacity
    from repro_torch.core.pipeline import UNCHUNKED_OF
    tokens_global = shape.global_batch * (
        shape.seq_len if shape.kind != "decode" else 1)
    seqpar = UNCHUNKED_OF.get(sched_name, sched_name) == "s1_seqpar"
    n_shard = max(nb, 1) * (max(sizes["mp"], 1) if seqpar else 1)
    s_local, cap = shard_pool_capacity(tokens_global, n_shard,
                                       sizes["mp"], cfg.moe.gate_config(),
                                       infer=shape.kind == "decode")
    return max(s_local, 1), cap


def placement_summary(cfg):
    """JSON-ready expert placement: None for dense or uniform configs."""
    if cfg.moe is None or cfg.moe.placement is None:
        return None
    pl = cfg.moe.placement
    if pl == "auto":
        from repro_torch.core import autosched
        live = autosched.current_placement()
        return {"mode": "auto", "epoch": autosched.placement_epoch(),
                "current": live.summary() if live is not None else None}
    return {"mode": "forced", "current": pl.summary()}


def active_param_count(cfg, n_params: int) -> float:
    """Active parameters per token: all less the unrouted experts'."""
    if cfg.moe is None:
        return float(n_params)
    moe = cfg.moe
    n_moe_layers = sum(1 for k in cfg.layer_kinds() if k.startswith("moe"))
    per_expert = moe.d_model * moe.d_ff * (3 if moe.glu else 2)
    inactive = n_moe_layers * per_expert * (moe.n_experts - moe.top_k)
    return float(n_params - inactive)


def zero_axes_for(cfg, dims, multi_pod: bool) -> tuple:
    """ZeRO-1's axes, as JAX's dry run picks them: the pure-DP axes, plus
    EP for a dense arch (``data`` serves EP for a MoE arch); ``data`` for
    a dense single-pod arch with none.  So a MoE arch gets none on the
    single-pod mesh and ``("pod",)`` on the multi-pod one."""
    axes = tuple(dims.dp) + (() if cfg.moe is not None else tuple(dims.ep))
    if not axes and cfg.moe is None and not multi_pod:
        axes = ("data",)
    return axes


def build_config(arch, shape_name, *, dtype="bfloat16", reduced=False,
                 cache_seq_shard=False, seq_parallel=False, saa_chunks=None,
                 pipeline_chunks=None, wire_dtype=None, seq=None,
                 batch_size=None):
    """``(cfg, shape, variant)`` of a combination, the flags applied as
    JAX's ``lower_one`` applies them; ``cfg`` None (and ``variant`` the
    reason) for a combination JAX skips."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    cfg, variant = variant_config(cfg, shape_name)
    if cfg is None:
        return None, None, variant
    cfg = replace(cfg, dtype=dtype)
    if cache_seq_shard:
        cfg = replace(cfg, context_parallel_decode=True)
    if seq_parallel:
        cfg = replace(cfg, seq_parallel=True)
    if cfg.moe is not None:
        kw = {}
        if saa_chunks is not None:
            kw["saa_chunks"] = saa_chunks
        if pipeline_chunks is not None:
            kw["pipeline_chunks"] = pipeline_chunks
        if wire_dtype is not None:
            from repro_torch.core.collectives import CommConfig
            kw["comm"] = replace(cfg.moe.comm or CommConfig(),
                                 wire_dtype=wire_dtype)
        cfg = replace(cfg, moe=replace(cfg.moe, **kw))
    shape = INPUT_SHAPES[shape_name]
    if seq or batch_size:
        shape = dataclasses.replace(
            shape, seq_len=seq or shape.seq_len,
            global_batch=batch_size or shape.global_batch)
    return cfg, shape, variant


def mesh_ranks(multi_pod: bool, test_mesh: bool = None) -> int:
    """The dry run's mesh size: the production mesh's, or the test mesh's
    with ``test_mesh`` (default: where ``REPRO_DRYRUN_DEVICES`` is below
    512, as JAX reads it)."""
    from repro_torch.launch.mesh import PRODUCTION_SHAPE, TEST_SHAPE
    if test_mesh is None:
        test_mesh = int(os.environ.get("REPRO_DRYRUN_DEVICES", "512")) < 512
    return math.prod((TEST_SHAPE if test_mesh else
                      PRODUCTION_SHAPE)[multi_pod][0])


def pick(cfg, shape, mesh, dims, schedule):
    """``(schedule, pipeline_chunks, wire_dtype)`` the MoE layers resolve,
    as JAX's dry run records it (``:179-224``): ``autosched.decide``
    over the chunk counts the pool allows, wire-only for a forced
    schedule, one chunk for a decode pool."""
    from repro_torch.core import autosched
    from repro_torch.core.perfmodel import MoELayerShape
    from repro_torch.core.pipeline import UNCHUNKED_OF, clamp_chunks
    from repro_torch.parallel.mesh import axis_size
    if cfg.moe is None:
        return schedule or "n/a", 0, "n/a"
    chunks = cfg.moe.pipeline_chunks
    wire = cfg.moe.comm.wire_dtype
    auto = not schedule and cfg.moe.schedule == "auto"
    if not (auto or wire == "auto"):
        return schedule or cfg.moe.schedule, chunks, wire
    sizes = dims.sizes(mesh)
    baxes = tuple(dims.batch_axes)
    nb = axis_size(mesh, baxes) if baxes else 1
    s_local, cap = moe_pool_cap(cfg, shape, sizes, nb,
                                schedule or cfg.moe.schedule)
    infer = shape.kind == "decode"
    cands = ((1,) if infer else
             tuple(sorted({clamp_chunks(cap // max(sizes["mp"], 1), n)
                           for n in autosched.DEFAULT_CHUNKS})))
    forced = None
    if not auto:
        base = schedule or cfg.moe.schedule
        forced = (UNCHUNKED_OF.get(base, base),)
        cands = (clamp_chunks(cap // max(sizes["mp"], 1), chunks),)
    decision = autosched.decide(
        MoELayerShape(B=1, L=s_local, M=cfg.d_model, H=cfg.moe.d_ff,
                      E=cfg.moe.n_experts, k=cfg.moe.top_k,
                      f=cfg.moe.capacity_factor, n_mp=sizes["mp"],
                      n_esp=sizes["esp"], n_ep=sizes["ep"], infer=infer),
        chunk_candidates=cands,
        wire_candidates=autosched.AUTO_WIRE if wire == "auto" else (wire,),
        schedules=forced)
    sched = decision.schedule if auto else schedule or cfg.moe.schedule
    if auto:
        chunks = decision.n_chunks
    if wire == "auto":
        wire = decision.wire_dtype
    return sched, chunks, wire


def plan_of(cfg, shape, mesh, dims, sched, chunks, wire):
    """The chosen schedule's plan graph as the MoE layers build it (same
    capacity, chunk clamp and wire): ``plan_summary`` and
    ``format_plan``."""
    from repro_torch.core.collectives import CommConfig
    from repro_torch.core.pipeline import UNCHUNKED_OF
    from repro_torch.core.plan import build_plan, format_plan, plan_summary
    from repro_torch.core.schedules import MoEShardInfo
    from repro_torch.parallel.mesh import axis_size
    sizes = dims.sizes(mesh)
    baxes = tuple(dims.batch_axes)
    nb = axis_size(mesh, baxes) if baxes else 1
    s_local, cap = moe_pool_cap(cfg, shape, sizes, nb, sched)
    info = MoEShardInfo(
        ep_axes=tuple(dims.ep), esp_axes=tuple(dims.esp),
        mp_axes=tuple(dims.mp), n_ep=sizes["ep"], n_esp=sizes["esp"],
        n_mp=sizes["mp"], tokens=s_local, cap=cap,
        gate=cfg.moe.gate_config(), glu=cfg.moe.glu,
        saa_chunks=cfg.moe.saa_chunks, pipeline_chunks=max(chunks, 1),
        comm=CommConfig(wire_dtype=wire if wire != "auto" else "f32",
                        scaling=(cfg.moe.comm or CommConfig()).scaling))
    p = build_plan(UNCHUNKED_OF.get(sched, sched), info)
    return plan_summary(p), format_plan(p)


# --- the real runs on the test mesh's ranks ----------------------------------

def rank_state(cfg, shape, mesh, dims, dev, zero_axes=()):
    """This rank's ``(model, params, opt_state, batch)`` for a real train
    step: ``Model.init`` at seed 0 (the same on every rank) cut to this
    rank's shards, the AdamW moments (ZeRO-1 over ``zero_axes``) and a
    batch of zeros, this rank's rows."""
    from repro_torch.analysis.layerwise import local_batch
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.parallel.sharding import local_tree
    from repro_torch.train.loop import zero1_layout
    model = Model(cfg, device=dev)
    full = model.init(torch.Generator(device=dev).manual_seed(0))
    params = local_tree(full, model.param_specs(full, mesh, dims), mesh)
    del full
    opt = adamw_init(params, mesh=mesh, zero=zero1_layout(
        model, params, mesh, dims, zero_axes))
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
             for k, v in local_batch(cfg, shape, mesh, dims).items()}
    return model, params, opt, batch


def train_metrics(metrics) -> dict:
    """The step's scalar metrics as floats (and ``expert_load``: the
    routed rows per expert, summed over layers, as a list)."""
    out = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
    el = metrics.get("expert_load")
    if el is not None and el.dim() == 1 and el.shape[-1]:
        out["expert_load"] = [float(c) for c in el.cpu()]
    return out


def run_rank(rank, job):
    """One rank of ``--run-step`` / ``--audit`` (``launch.mesh.spawn``):
    ``job`` holds ``cfg``, ``shape``, ``multi_pod``, ``schedule``,
    ``zero_axes``, ``guards``, ``run_step`` and ``audit``.  Returns
    ``step_metrics``, ``moment_bytes`` (this rank's AdamW moments) and
    ``launches`` (each kernel's launches, counted from 0) of the step,
    and the ``audit`` reports."""
    from repro_torch.analysis.layerwise import tree_bytes
    from repro_torch.kernels import registry
    from repro_torch.launch.mesh import dims_for, make_test_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import (make_guarded_train_step,
                                        make_train_step)
    cfg, shape = job["cfg"], job["shape"]
    dev = (torch.device("cpu") if job["device"] == "cpu" else
           torch.device("cuda", torch.cuda.current_device()))
    mesh = make_test_mesh(multi_pod=job["multi_pod"])
    out = {}
    if job["run_step"]:
        dims = dims_for(cfg, job["multi_pod"])
        model, params, opt, batch = rank_state(cfg, shape, mesh, dims, dev,
                                               job["zero_axes"])
        args = (model, AdamWConfig(), job["schedule"], mesh, dims,
                job["zero_axes"])
        registry.launches(reset=True)
        if job["guards"]:
            _, _, m = make_guarded_train_step(*args)(params, opt, batch,
                                                     1.0, 0.0)
        else:
            _, _, m = make_train_step(*args)(params, opt, batch)
        out["launches"] = registry.launches()
        out["step_metrics"] = train_metrics(m)
        out["moment_bytes"] = tree_bytes(opt["mu"]) + tree_bytes(opt["nu"])
    if job["audit"]:
        from repro_torch.obs.audit import (DEFAULT_AUDIT_SCHEDULES,
                                           run_schedule_audit)
        from repro_torch.parallel.mesh import ParallelDims, make_mesh
        a_mesh = mesh if mesh.axis_names == ("data", "model") else \
            make_mesh((4, 2), ("data", "model"))
        out["audit"] = run_schedule_audit(
            cfg.moe, 256, schedules=DEFAULT_AUDIT_SCHEDULES, iters=3,
            warmup=1, device=dev, mesh=a_mesh,
            dims=ParallelDims(ep=("data",), esp=("model",), mp=("model",)))
    return out


def run_on_ranks(job, device="cuda"):
    """Spawn the test mesh's ranks over gloo on ``device`` and run
    :func:`run_rank` on each; returns every rank's result.  On the card
    the kernels are built once here first."""
    from repro_torch.launch.mesh import spawn
    if device != "cpu":
        from repro_torch.kernels import _build
        _build.build_all()
    threads = max(1, (os.cpu_count() or 1) // TEST_RANKS) \
        if device == "cpu" else None
    return spawn(run_rank, TEST_RANKS, dict(job, device=device),
                 backend="gloo", device=device, threads=threads)


# --- one combination -----------------------------------------------------------

def dry_one(arch: str, shape_name: str, multi_pod: bool,
            schedule: str = None, dtype: str = "bfloat16",
            save_hlo: bool = False, cache_seq_shard: bool = False,
            saa_chunks: int = None, seq_parallel: bool = False,
            pipeline_chunks: int = None, run_step: bool = False,
            reduced: bool = False, seq: int = None, batch_size: int = None,
            wire_dtype: str = None, dump_plan: bool = False,
            guards: bool = False, audit: bool = False,
            device: str = "cuda", rank: int = 0,
            test_mesh: bool = None) -> dict:
    """Trace one combination as rank ``rank`` of its mesh on the meta
    device (JAX's ``lower_one``'s arguments, plus ``device`` for the real
    runs, ``rank`` and ``test_mesh``: :func:`mesh_ranks`); returns the
    record."""
    import torch.distributed as dist

    from repro_torch.analysis.layerwise import (full_param_shapes,
                                                count_params, make_step,
                                                measure, meta_state,
                                                tree_bytes)
    from repro_torch.analysis.roofline import (effective_link_bw,
                                               roofline_terms)
    from repro_torch.launch.mesh import (dims_for, fake_world,
                                         make_production_mesh,
                                         make_test_mesh)
    from repro_torch.models.model import Model
    if save_hlo:
        raise ValueError("--save-hlo: the port traces eager PyTorch on "
                         "the meta device; there is no HLO to save")
    mesh_name = "multi" if multi_pod else "single"
    cfg, shape, variant = build_config(
        arch, shape_name, dtype=dtype, reduced=reduced,
        cache_seq_shard=cache_seq_shard, seq_parallel=seq_parallel,
        saa_chunks=saa_chunks, pipeline_chunks=pipeline_chunks,
        wire_dtype=wire_dtype, seq=seq, batch_size=batch_size)
    if cfg is None:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "skipped": variant}
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake "
                           "torch.distributed world; one is running")
    world = mesh_ranks(multi_pod, test_mesh)
    fake_world(world, rank)
    try:
        mesh = (make_production_mesh(multi_pod=multi_pod) if world >= 256
                else make_test_mesh(multi_pod=multi_pod))
        dims = dims_for(cfg, multi_pod)
        sched_pick, chunks_pick, wire_pick = pick(cfg, shape, mesh, dims,
                                                  schedule)
        plan_dump = None
        if dump_plan and cfg.moe is not None and sched_pick != "n/a":
            plan_dump, text = plan_of(cfg, shape, mesh, dims, sched_pick,
                                      chunks_pick, wire_pick)
            print(text, flush=True)
        zero_axes = zero_axes_for(cfg, dims, multi_pod) \
            if shape.kind == "train" else ()
        model = Model(cfg, device="meta")
        full = full_param_shapes(cfg)
        state = meta_state(model, mesh, dims, shape, zero_axes=zero_axes,
                           seq_shard=cache_seq_shard, full=full)
        out, costs = measure(make_step(model, mesh, dims, shape, state,
                                       schedule=schedule, guards=guards,
                                       zero_axes=zero_axes))
        link = effective_link_bw(costs["coll_by_group"], mesh)
    finally:
        dist.destroy_process_group()

    n_params = count_params(full)
    n_active = active_param_count(cfg, n_params)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (3.0 if shape.kind == "train" else 1.0) \
        * 2.0 * n_active * tokens        # 6ND = 3 * 2ND
    opt = state["opt_state"]
    parts = {"params_bytes": tree_bytes(state["params"]),
             "opt_state_bytes": tree_bytes(opt),
             "batch_bytes": tree_bytes(state["batch"]),
             "cache_bytes": tree_bytes(state["cache"]),
             "ctx_kv_bytes": tree_bytes(state["ctx_kv"])}
    args_b = sum(parts.values())
    # the arguments the step updates in place: params and AdamW state to
    # train, the cache to decode
    alias = parts["params_bytes"] + parts["opt_state_bytes"] \
        + parts["cache_bytes"]
    mem = {"argument_size_in_bytes": args_b,
           "output_size_in_bytes": sum(
               t.numel() * t.element_size() for t in tree_flatten(out)[0]
               if isinstance(t, torch.Tensor)),
           "temp_size_in_bytes": costs["peak_bytes"],
           "generated_code_size_in_bytes": None,
           "alias_size_in_bytes": alias, **parts,
           "moments_bytes": tree_bytes(opt["mu"]) + tree_bytes(opt["nu"])
           if opt is not None else 0}
    chips = mesh.size
    rl = roofline_terms({"flops": costs["flops"] * chips,
                         "bytes accessed": costs["bytes"] * chips},
                        costs["coll"], chips, model_flops, dtype=dtype,
                        link=link)

    step_metrics = audit_reports = ranks = None
    run_step = run_step and shape.kind == "train"
    audit = audit and cfg.moe is not None
    if run_step or audit:
        ranks = run_on_ranks({"cfg": cfg, "shape": shape,
                              "multi_pod": multi_pod, "schedule": schedule,
                              "zero_axes": zero_axes, "guards": guards,
                              "run_step": run_step, "audit": audit},
                             device=device)
        step_metrics = ranks[0].get("step_metrics")
        audit_reports = ranks[0].get("audit")
    if step_metrics is not None:
        print(f"[step] {arch} x {shape_name} sched={sched_pick} "
              f"wire={wire_pick} "
              f"loss={step_metrics.get('loss', float('nan')):.4f}",
              flush=True)
    for rep in audit_reports or ():
        print(f"[audit] {rep['schedule']}: measured "
              f"{rep['total_measured_s'] * 1e3:.3f} ms, predicted "
              f"{rep['total_predicted_s'] * 1e3:.3f} ms, time_scale "
              f"{rep['calibration']['time_scale']:.3g}, worst "
              f"{rep['worst'][:3]}", flush=True)
    total = args_b + costs["peak_bytes"]
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "variant": (variant + ("+reduced" if reduced else "")).lstrip("+"),
        "schedule": sched_pick, "pipeline_chunks": chunks_pick,
        "wire_dtype": wire_pick,
        "placement": placement_summary(cfg),
        "plan": plan_dump,
        "audit": audit_reports,
        "step_metrics": step_metrics,
        "robustness": {"guards": True,
                       "nonfinite": (step_metrics or {}).get("nonfinite"),
                       "lr_scale": 1.0} if guards else None,
        "chips": chips, "dtype": dtype,
        "n_params": n_params, "n_active_params": n_active,
        "tokens_per_step": tokens,
        "trace_s": costs["trace_s"],
        "memory_analysis": mem,
        "fits_80gb": total <= HBM_BYTES,
        "zero1_axes": list(zero_axes),
        "cost_flops": costs["flops"],
        "cost_bytes": costs["bytes"],
        "collectives": {"counts": costs["coll_counts"],
                        "bytes": costs["coll_by_kind"],
                        "total_bytes": costs["coll"]},
        "roofline": rl.as_dict(),
        "kernels": costs["kernels"],
        "rank_moment_bytes": [r.get("moment_bytes") for r in ranks]
        if step_metrics is not None else None,
        "rank_launches": [r.get("launches") for r in ranks]
        if step_metrics is not None else None,
    }


def save(rec: dict, suffix: str = "", art_dir: str = ART_DIR) -> str:
    os.makedirs(art_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json"
    with open(os.path.join(art_dir, name), "w") as f:
        json.dump(rec, f, indent=1)
    return name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--schedule", default=None,
                    help="force a Parm schedule (baseline/s1/s2/s1_seqpar/"
                         "s2h or a pipelined *_pipe variant)")
    ap.add_argument("--dump-plan", action="store_true",
                    help="print the chosen schedule's plan-IR stage graph "
                         "and record it in the artifact JSON")
    ap.add_argument("--audit", action="store_true",
                    help="run the predicted-vs-measured schedule audit "
                         "(s1/s2/s1g stage timings vs the perf model) on "
                         "a 4x2 mesh of 8 gloo ranks on --device (pair "
                         "with --reduced)")
    ap.add_argument("--pipeline-chunks", type=int, default=None,
                    help="micro-chunk count for the pipelined bodies")
    ap.add_argument("--wire-dtype", default=None,
                    choices=["f32", "bf16", "fp8_e4m3", "auto"],
                    help="wire format for the MoE collectives (auto = "
                         "joint autosched decision per layer shape)")
    ap.add_argument("--run-step", action="store_true",
                    help="after tracing a train combo, run ONE real "
                         "optimizer step on the test mesh's 8 gloo ranks "
                         "on --device (use with --reduced/--seq/--batch)")
    ap.add_argument("--guards", action="store_true",
                    help="trace the GUARDED train step (non-finite "
                         "skip-step + LR backoff) and record the guard "
                         "outcome of --run-step")
    ap.add_argument("--reduced", action="store_true",
                    help="trace the smoke-scale config variant")
    ap.add_argument("--seq", type=int, default=None,
                    help="override the input shape's sequence length")
    ap.add_argument("--batch", type=int, default=None,
                    help="override the input shape's global batch")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="refused: the port has no HLO")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip combos whose artifact JSON already exists")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="Megatron-SP residual stream")
    ap.add_argument("--cache-seq-shard", action="store_true",
                    help="split the KV caches' length over MP (decode: "
                         "train.loop.cache_specs(seq_shard=True))")
    ap.add_argument("--saa-chunks", type=int, default=None,
                    help="override SAA pipeline depth (1 = AAS, no overlap)")
    ap.add_argument("--tag", default="",
                    help="artifact filename suffix for perf iterations")
    ap.add_argument("--device", default="cuda",
                    help="where --run-step and --audit run (cuda or cpu); "
                         "the trace itself is on the meta device")
    ap.add_argument("--rank", type=int, default=0,
                    help="the mesh rank to trace")
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo: the port traces eager PyTorch on the meta "
                 "device; there is no HLO to save")
    if (args.run_step or args.audit) and args.device != "cpu":
        from repro_torch.launch.common import resolve_device
        resolve_device(args.device)

    archs = list(ASSIGNED) if args.all or not args.arch else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or not args.shape \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'multi' if mp else 'single'}"
                sfx = f"__{args.schedule}" if args.schedule else ""
                if args.tag:
                    sfx += f"__{args.tag}"
                if args.skip_existing and os.path.exists(os.path.join(
                        ART_DIR, f"{arch}__{shape}__"
                        f"{'multi' if mp else 'single'}{sfx}.json")):
                    print(f"[have] {tag}", flush=True)
                    continue
                try:
                    rec = dry_one(arch, shape, mp, args.schedule,
                                  args.dtype,
                                  cache_seq_shard=args.cache_seq_shard,
                                  saa_chunks=args.saa_chunks,
                                  seq_parallel=args.seq_parallel,
                                  pipeline_chunks=args.pipeline_chunks,
                                  run_step=args.run_step,
                                  reduced=args.reduced, seq=args.seq,
                                  batch_size=args.batch,
                                  wire_dtype=args.wire_dtype,
                                  dump_plan=args.dump_plan,
                                  guards=args.guards, audit=args.audit,
                                  device=args.device, rank=args.rank)
                    save(rec, sfx)
                    if rec.get("skipped"):
                        print(f"[skip] {tag}: {rec['skipped']}", flush=True)
                        continue
                    m = rec["memory_analysis"]
                    rl = rec["roofline"]
                    print(f"[ok]   {tag} sched={rec['schedule']} "
                          f"trace={rec['trace_s']:.1f}s "
                          f"flops={rec['cost_flops']:.3g} "
                          f"coll={rec['collectives']['total_bytes']:.3g}B "
                          f"args={m['argument_size_in_bytes'] / 1e9:.2f}GB "
                          f"temp={m['temp_size_in_bytes'] / 1e9:.2f}GB "
                          f"fits_80gb={rec['fits_80gb']} "
                          f"bound={rl['bottleneck']} (modeled)", flush=True)
                except Exception as e:  # noqa: BLE001
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e!r}", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: "
                         + "; ".join(t for t, _ in failures))
    print("dry-run complete: all combinations traced.")


if __name__ == "__main__":
    main()
