"""Training launcher of the port, on one CUDA card or on several ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \\
      --layers 4 --seq 2048 --batch 1 --steps 10 --lr 1e-4
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-moe \\
      --schedule s1 --pipeline-chunks 2 --steps 10
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-moe \\
      --reduced --device cpu --steps 3

The flags are the JAX launcher's for what the port runs, plus ``--device``
and ``--profile``: ``--schedule`` takes every name of the JAX package's
``SCHEDULES``, ``--pipeline-chunks`` the ``*_pipe`` bodies' chunk count,
``--wire-dtype`` f32, bf16, fp8_e4m3 or auto (the autoscheduler picks
f32 or bf16 jointly with the schedule) and
``--autosched analytic|measured`` how ``"auto"`` decides: from the cost
model, or by timing every candidate on the card once per layer shape.
After the first step the run prints one ``autosched[...]`` line per
decision.
``--layers N`` cuts the depth and keeps the full width (with
``--reduced``, the reduced config's depth); ``--d-model D`` cuts the
width as JAX's flag does (with ``--reduced``, the reduced config's).  Weights are random from a
fixed seed; batches are ``SyntheticLM``'s.  Without a CUDA card the
launcher stops with an error; ``--device cpu`` asks for the CPU.

``--guards`` runs the fault-tolerant loop (skip-step, LR backoff,
rollback to the checkpoints under ``--ckpt``, the fp8 overflow fallback);
``--faults SPEC`` (implies ``--guards``) injects seeded faults, e.g.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-moe \
      --reduced --device cpu --steps 12 --faults "nan_grad@step=5-7" \
      --ckpt /tmp/ck --max-skips 2

and a guarded run ends with the JAX launcher's chaos contract: a finite
final loss, at least one skipped step under a ``nan_grad`` plan, and
``CHAOS TRAIN OK``.

Telemetry, as in JAX: ``--metrics-dir DIR`` streams the run's events
(``train_step`` per logged step, the guards' events, ``fp8_sat``) as JSONL
into DIR; ``--trace`` (needs ``--metrics-dir``) then times the MoE
layer's plan stages (CUDA events on the card) and writes a Chrome trace
there; ``--log-json FILE`` writes the history (with ``--guards``,
``--metrics-dir`` or ``--placement auto``: a record of the history, the
guard counters and events, the LR scale, the telemetry files and the
placement).

``--placement auto`` runs the JAX launcher's load-adaptive expert
placement: the MoE layers run the autoscheduler's live placement, and
every ``--rebalance-every`` steps (default 50) the ``Trainer`` scores a
replication of the hot experts, derived from the load EMA, against
uniform with the cost model and installs it on a win (a ``REBALANCE``
line).  A placement needs more than one EP rank: on one rank the flag is
taken and changes nothing, as in JAX.  E.g. on the card

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-moe \
      --layers 2 --nproc 4 --mesh data=2,model=2 --dist-backend gloo \
      --steps 20 --placement auto --rebalance-every 5

Across ranks: ``--nproc N`` spawns N ranks (``torch.multiprocessing``,
``spawn``) unless ``torchrun``'s environment is present, on the
``--mesh data=D,model=M`` mesh (default ``data=N,model=1``; EP over data,
ESP == MP over model; with M > 1 the dense layers train under Megatron
tensor parallelism over model: attention by head, the dense FFN column /
row, the embedding and LM head by vocabulary, as the JAX launcher's
GSPMD shards them, and Megatron-SP where the config sets
``seq_parallel``) over ``--dist-backend nccl`` (one card a rank) or
``gloo`` (named explicitly: ranks sharing one card, or the CPU), e.g.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-moe \
      --reduced --device cpu --nproc 4 --mesh data=2,model=2 \
      --dist-backend gloo --steps 3

``--multi-pod`` lays the ranks out as JAX's multi-pod mesh does,
``(pod, data, model)`` with pod pure data parallel
(``production_dims(multi_pod=True)``; ``--mesh pod=P,data=D,model=M``,
default ``pod=2,data=N/4,model=2``).
Rank 0 prints the step lines and ``final loss``; a rank's failure fails
the run.  The guarded loop, its faults and checkpoints run across ranks
as on one (every rank's guard decision held equal; checkpoints are whole
arrays, gathered from the shards and written by rank 0), e.g.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-moe \
      --reduced --device cpu --nproc 4 --mesh data=2,model=2 \
      --dist-backend gloo --steps 8 --seq 32 --max-skips 2 \
      --faults "nan_grad@step=3-5;ckpt_bitflip@save=2" --ckpt /tmp/ck \
      --metrics-dir /tmp/m --trace --log-json /tmp/m/log.json

The run writes one telemetry stream (rank 0's: the global step metrics,
the guards' events, every rank's ``fp8_sat``; its meta names
``n_devices`` and the mesh), ``--trace`` times the layer's plan stages
on the mesh (the slowest rank's time a stage), ``--profile`` profiles
one step on every rank (rank 0 prints its own), and rank 0 alone writes
``--log-json`` and checks the chaos contract.  ``--autosched measured``
across ranks times every candidate on the live mesh, every rank taking
the slowest rank's time, so that every rank picks the same schedule.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from dataclasses import replace

import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core.collectives import CommConfig
from repro_torch.core.schedules import SCHEDULES
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.common import device_profile, resolve_device
from repro_torch.launch.mesh import (check_backend, dims_for, parse_mesh,
                                     spawn, torchrun_env)
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import FaultPlan, GuardConfig
from repro_torch.train import Trainer

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None,
                    help="cut the width (with --reduced: the reduced "
                         "config's d_model, default 256)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default=None, choices=SCHEDULES,
                    help="Parm schedule override (default auto: the "
                         "autoscheduler decides)")
    ap.add_argument("--pipeline-chunks", type=int, default=None,
                    help="micro-chunk count for the pipelined bodies "
                         "(1 = unchunked)")
    ap.add_argument("--autosched", default=None,
                    choices=["analytic", "measured"],
                    help="how schedule/wire 'auto' decides: the cost "
                         "model, or a one-shot timing of every candidate "
                         "(across ranks on the live mesh, the slowest "
                         "rank's time)")
    ap.add_argument("--wire-dtype", default=None,
                    choices=["f32", "bf16", "fp8_e4m3", "auto"],
                    help="wire format of the MoE collectives (on one rank "
                         "the codec's round trip)")
    ap.add_argument("--placement", default="uniform",
                    choices=["uniform", "auto"],
                    help="expert placement: uniform (one expert per slot, "
                         "the default) or auto (load-adaptive replication "
                         "of hot experts, rebalanced from the live load "
                         "EMA every --rebalance-every steps)")
    ap.add_argument("--rebalance-every", type=int, default=50,
                    help="steps between placement rebalance checks "
                         "(--placement auto; 0 disables rebalancing)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint period in steps (default: steps/2 "
                         "when --ckpt is set)")
    ap.add_argument("--retain", type=int, default=3,
                    help="retained checkpoints under --guards (last k)")
    ap.add_argument("--guards", action="store_true",
                    help="fault-tolerant loop: non-finite skip-step + LR "
                         "backoff, loss-spike detection, checkpoint "
                         "rollback (needs --ckpt), fp8 overflow fallback")
    ap.add_argument("--max-skips", type=int, default=3,
                    help="consecutive skipped steps before rollback")
    ap.add_argument("--faults", default=None,
                    help="fault-injection spec, e.g. 'nan_grad@step=5-8;"
                         "fp8_sat@factor=64;ckpt_bitflip@save=2' "
                         "(see repro_torch.runtime.faults; implies "
                         "--guards)")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--log-json", default=None)
    ap.add_argument("--metrics-dir", default=None)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nproc", type=int, default=1,
                    help="ranks to spawn (torch.distributed); 1 = this "
                         "process alone")
    ap.add_argument("--mesh", default=None,
                    help="the rank mesh, e.g. data=2,model=2 (default "
                         "data=NPROC,model=1); model > 1 shards the dense "
                         "layers (Megatron tensor parallelism)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="lay the ranks out as (pod, data, model) with the "
                         "multi-pod dims (pod pure data parallel); --mesh "
                         "then names pod=P,data=D,model=M (default "
                         "pod=2,data=NPROC/4,model=2)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend (required with more "
                         "than one rank): nccl needs a card a rank, gloo "
                         "shares one card or runs on the CPU")
    ap.add_argument("--profile", action="store_true",
                    help="after training, run one more step under "
                         "torch.profiler; print device time by kernel and "
                         "the device's busy share (CUDA only)")
    args = ap.parse_args(argv)
    if args.rebalance_every < 0:
        ap.error("--rebalance-every must be >= 0")
    if args.trace and not args.metrics_dir:
        ap.error("--trace requires --metrics-dir")
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    if args.pipeline_chunks is not None and args.pipeline_chunks < 1:
        ap.error("--pipeline-chunks must be >= 1")
    multi = args.nproc > 1 or torchrun_env()
    if args.nproc < 1:
        ap.error("--nproc must be >= 1")
    dev = resolve_device(args.device)
    if args.profile and dev.type != "cuda":
        ap.error("--profile measures the card: it needs --device cuda")
    if multi:
        if args.dist_backend is None:
            ap.error("more than one rank needs --dist-backend nccl|gloo")
        world = (int(os.environ["WORLD_SIZE"]) if torchrun_env()
                 else args.nproc)
        try:
            shape, names = parse_mesh(_mesh_spec(args, world), world)
            check_backend(args.dist_backend, world, dev.type)
        except (ValueError, RuntimeError) as e:
            ap.error(str(e))
        want = _AXES[args.multi_pod]
        if names != want:
            ap.error(f"--mesh names the launcher's axes: "
                     f"{'=N,'.join(want)}=N (got {names})")
        rows = math.prod(shape[:-1])
        if args.batch % rows:
            ap.error(f"--batch {args.batch} does not split over "
                     f"{dict(zip(names[:-1], shape[:-1]))}")
        if torchrun_env():
            return _rank(int(os.environ["RANK"]), args, argv)
        spawn(_rank, args.nproc, args, argv, backend=args.dist_backend,
              device=dev.type, threads=_threads(args.nproc, dev))
        return None
    if args.mesh or args.dist_backend or args.multi_pod:
        ap.error("--mesh, --multi-pod and --dist-backend need --nproc > 1")
    return _train(args, argv, dev)


#: the launcher's mesh axes, by --multi-pod
_AXES = {False: ("data", "model"), True: ("pod", "data", "model")}


def _mesh_spec(args, world: int) -> str:
    """``--mesh``, or its default: ``data=N,model=1``, or with
    ``--multi-pod`` ``pod=2,data=N/4,model=2``."""
    if args.mesh:
        return args.mesh
    if args.multi_pod:
        return f"pod=2,data={max(world // 4, 1)},model=2"
    return f"data={world},model=1"


def _threads(nproc, dev):
    """CPU threads a rank: the cores shared out (the CPU rehearsal)."""
    if dev.type != "cpu":
        return None
    return max(1, (os.cpu_count() or 1) // nproc)


def _rank(rank, args, argv):
    """One rank of a multi-rank run (``torch.distributed`` started by
    ``launch.mesh.spawn`` or ``torchrun``): the mesh, then the run.  Only
    rank 0 writes to stdout."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.parallel.mesh import make_mesh
    if not dist.is_initialized():          # torchrun: start it here
        init_distributed(args.dist_backend, device=args.device)
    world = dist.get_world_size()
    shape, names = parse_mesh(_mesh_spec(args, world), world)
    mesh = make_mesh(shape, names)
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    dev = (torch.device("cpu") if args.device == "cpu" else
           torch.device("cuda", torch.cuda.current_device()))
    print(f"ranks: {world} on mesh {mesh.shape} over "
          f"{dist.get_backend()}", flush=True)
    return _train(args, argv, dev, mesh=mesh)


def _train(args, argv, dev, mesh=None):
    """The run itself, on one rank (``mesh=None``) or as this rank of
    ``mesh``."""
    cfg = get_config(args.arch)
    if cfg.moe is not None:
        moe_kw = {}
        if args.pipeline_chunks is not None:
            moe_kw["pipeline_chunks"] = args.pipeline_chunks
        if args.autosched:
            moe_kw["autosched"] = args.autosched
        if args.wire_dtype:
            moe_kw["comm"] = replace(cfg.moe.comm or CommConfig(),
                                     wire_dtype=args.wire_dtype)
        if args.placement == "auto":
            # the MoE layers read the live placement from the
            # autoscheduler's registry; the Trainer drives the rebalances
            moe_kw["placement"] = "auto"
        cfg = replace(cfg, moe=replace(cfg.moe, **moe_kw))
    if args.reduced:
        cfg = cfg.reduced(n_layers=args.layers or 2,
                          d_model=args.d_model or 256)
    elif args.layers or args.d_model:
        cfg = replace(cfg, n_layers=args.layers or cfg.n_layers,
                      d_model=args.d_model or cfg.d_model)

    lead = mesh is None or mesh.rank == 0      # writes the run's files
    if args.metrics_dir and lead:
        obs.configure(args.metrics_dir, meta={
            "kind": "train", "arch": args.arch, "steps": args.steps,
            "seq_len": args.seq, "batch": args.batch,
            "schedule": args.schedule, "device": str(dev),
            "n_devices": 1 if mesh is None else mesh.size,
            "mesh": None if mesh is None else dict(mesh.shape),
            "argv": sys.argv[1:] if argv is None else list(argv)})
    model = Model(cfg, device=dev)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps)
    guards = faults = None
    if args.faults:
        faults = FaultPlan.parse(args.faults, seed=args.fault_seed)
        print(f"fault plan: {faults.summary()}", flush=True)
    if args.guards or faults is not None:
        guards = GuardConfig(max_skips=args.max_skips)
    dims = dims_for(cfg, args.multi_pod) if mesh is not None else None
    placement = args.placement if cfg.moe is not None else "uniform"
    tr = Trainer(model, opt, schedule=args.schedule, ckpt_path=args.ckpt,
                 guards=guards, faults=faults, ckpt_retain=args.retain,
                 mesh=mesh, dims=dims,
                 placement="auto" if placement == "auto" else None,
                 rebalance_every=args.rebalance_every)
    params, opt_state = tr.setup(torch.Generator(device=dev).manual_seed(0))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, global_batch=args.batch))
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"device: {where}; {cfg.name} with {cfg.n_layers} layers, "
          f"batch {args.batch} x {args.seq} tokens", flush=True)
    if cfg.moe is not None:
        print(f"moe: schedule {args.schedule or cfg.moe.schedule}, "
              f"{cfg.moe.pipeline_chunks} chunk(s), wire "
              f"{cfg.moe.comm.wire_dtype}, autosched {cfg.moe.autosched}, "
              f"placement {placement}", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ckpt_every = args.ckpt_every or (args.steps // 2 if args.ckpt else 0)
    params, opt_state, hist = tr.run(params, opt_state, data, args.steps,
                                     ckpt_every=ckpt_every if args.ckpt
                                     else 0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    tokens = args.steps * args.batch * args.seq
    print(f"{args.steps} steps in {wall:.3f} s: {wall / args.steps * 1e3:.1f}"
          f" ms/step, {tokens / wall:.1f} tokens/s (first step included)")
    if dev.type == "cuda":
        print(f"peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    if args.profile:
        # every rank profiles its own step (they run its collectives
        # together); rank 0 prints its table
        batch = tr.batch(data, args.steps)
        t1 = time.perf_counter()
        tr.train_step(params, opt_state, batch)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t1) * 1e3
        prof = device_profile(
            lambda: tr.train_step(params, opt_state, batch), wall_ms)
        print(f"profile: one step, device busy {prof['busy_ms']:.1f} ms "
              f"(profiled) over {wall_ms:.1f} ms wall (unprofiled): "
              f"{100 * prof['busy_share']:.1f}% busy; {prof['n_kernels']} "
              f"kernel launches")
        for title, key in (("by kernel", "top"), ("by op", "top_ops")):
            print(f" device time {title}:")
            for row in prof[key]:
                print(f"  {row['ms']:9.3f} ms {row['calls']:6d} x  "
                      f"{row['name'][:90]}")
    trace_file = None
    if args.trace:
        if cfg.moe is None:
            print("--trace: dense arch has no MoE plan stages; skipping",
                  flush=True)
        else:
            from repro_torch.obs.audit import trace_schedule
            from repro_torch.obs.trace import save_chrome_trace
            sched = args.schedule
            if sched in (None, "auto") or sched.endswith("_seqpar"):
                sched = "s1"   # concrete, trace-compatible default
            st = trace_schedule(cfg.moe, args.batch * args.seq, sched,
                                n_chunks=args.pipeline_chunks or 1,
                                device=dev, mesh=mesh, dims=dims)
            trace_file = os.path.join(args.metrics_dir,
                                      f"trace_{sched}.json")
            if lead:
                save_chrome_trace(st, trace_file)
            obs.emit("stage_trace", schedule=sched, path=trace_file,
                     total_s=st.total_s, n_stages=st.n_stages)
            print(f"stage trace ({sched}, {st.n_stages} stages, "
                  f"{st.total_s * 1e3:.3f} ms) -> {trace_file}", flush=True)

    metrics_files = None
    if obs.enabled():
        metrics_files = list(obs.get_sink().paths)
        obs.close()
    if not lead:
        return
    if args.log_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.log_json)),
                    exist_ok=True)
        rec = hist if (guards is None and placement != "auto"
                       and not args.metrics_dir) else {"history": hist}
        if args.metrics_dir:
            rec["obs"] = {"metrics_dir": args.metrics_dir,
                          "metrics_files": metrics_files,
                          "trace_file": trace_file}
        if guards is not None:
            rec.update({"guards": dict(tr.guard_state.counters),
                        "guard_events": tr.guard_state.events,
                        "lr_scale": tr.guard_state.lr_scale})
        if placement == "auto":
            from repro_torch.core import autosched
            pl = autosched.current_placement()
            rec["placement"] = {
                "mode": "auto",
                "rebalance_every": args.rebalance_every,
                "epoch": autosched.placement_epoch(),
                "current": pl.summary() if pl is not None else None,
                "load_ema": [round(float(v), 3)
                             for v in tr.load_ema.value()]}
        with open(args.log_json, "w") as f:
            json.dump(rec, f, indent=1)
    if guards is not None:
        gs = tr.guard_state
        # the chaos contract: an injected-fault run must still END finite
        if not math.isfinite(hist[-1]["loss"]):
            raise SystemExit(f"guarded run ended non-finite: "
                             f"{hist[-1]['loss']}")
        if faults is not None and gs.counters["skipped"] == 0 and any(
                s.kind == "nan_grad" for s in faults.specs):
            raise SystemExit("nan_grad fault injected but no step was "
                             "skipped")
        print(f"CHAOS TRAIN OK  final loss {hist[-1]['loss']:.4f}  "
              f"({gs.counters['skipped']} skipped, "
              f"{gs.counters['rollbacks']} rollbacks)", flush=True)
    print(f"final loss {hist[-1]['loss']:.4f} (start {hist[0]['loss']:.4f})")


if __name__ == "__main__":
    main()
