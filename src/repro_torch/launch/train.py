"""Training launcher of the port, on one CUDA card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \\
      --layers 4 --seq 2048 --batch 1 --steps 10 --lr 1e-4
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-moe \\
      --schedule s1 --pipeline-chunks 2 --steps 10
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-moe \\
      --reduced --device cpu --steps 3

The flags are the JAX launcher's for what the port runs, plus ``--device``
and ``--profile``: ``--schedule`` takes every name of the JAX package's
``SCHEDULES`` (run on one rank), ``--pipeline-chunks`` the ``*_pipe``
bodies' chunk count and ``--wire-dtype`` f32, bf16 or fp8_e4m3.
``--layers N`` cuts the depth and keeps the full width (with
``--reduced``, the reduced config's depth).  Weights are random from a
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
there; ``--log-json FILE`` writes the history (with ``--guards`` or
``--metrics-dir``: a record of the history, the guard counters and
events, the LR scale and the telemetry files).  Flags of the JAX launcher
for what later slices bring (``--wire-dtype auto``, ``--autosched``,
``--placement auto``) are refused with an error, never ignored.
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
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import FaultPlan, GuardConfig
from repro_torch.train import Trainer

LATER = "comes with a later slice of the port"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default=None, choices=SCHEDULES,
                    help="Parm schedule override, run on one rank (auto "
                         "resolves to s1g there)")
    ap.add_argument("--pipeline-chunks", type=int, default=None,
                    help="micro-chunk count for the pipelined bodies "
                         "(1 = unchunked)")
    ap.add_argument("--autosched", default=None,
                    choices=["analytic", "measured"])
    ap.add_argument("--wire-dtype", default=None,
                    choices=["f32", "bf16", "fp8_e4m3", "auto"],
                    help="wire format of the MoE collectives (on one rank "
                         "the codec's round trip)")
    ap.add_argument("--placement", default="uniform",
                    choices=["uniform", "auto"])
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
    ap.add_argument("--profile", action="store_true",
                    help="after training, run one more step under "
                         "torch.profiler; print device time by kernel and "
                         "the device's busy share (CUDA only)")
    args = ap.parse_args(argv)
    for flag, used in (("--placement auto", args.placement == "auto"),
                       ("--autosched", args.autosched),
                       ("--wire-dtype auto", args.wire_dtype == "auto")):
        if used:
            ap.error(f"{flag} {LATER}")
    if args.trace and not args.metrics_dir:
        ap.error("--trace requires --metrics-dir")
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    if args.pipeline_chunks is not None and args.pipeline_chunks < 1:
        ap.error("--pipeline-chunks must be >= 1")
    dev = resolve_device(args.device)
    if args.profile and dev.type != "cuda":
        ap.error("--profile measures the card: it needs --device cuda")

    cfg = get_config(args.arch)
    if cfg.moe is not None:
        moe_kw = {}
        if args.pipeline_chunks is not None:
            moe_kw["pipeline_chunks"] = args.pipeline_chunks
        if args.wire_dtype:
            moe_kw["comm"] = replace(cfg.moe.comm or CommConfig(),
                                     wire_dtype=args.wire_dtype)
        cfg = replace(cfg, moe=replace(cfg.moe, **moe_kw))
    if args.reduced:
        cfg = cfg.reduced(n_layers=args.layers or 2)
    elif args.layers:
        cfg = replace(cfg, n_layers=args.layers)

    if args.metrics_dir:
        obs.configure(args.metrics_dir, meta={
            "kind": "train", "arch": args.arch, "steps": args.steps,
            "seq_len": args.seq, "batch": args.batch,
            "schedule": args.schedule, "device": str(dev),
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
    tr = Trainer(model, opt, schedule=args.schedule, ckpt_path=args.ckpt,
                 guards=guards, faults=faults, ckpt_retain=args.retain)
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
              f"{cfg.moe.comm.wire_dtype}", flush=True)
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
        batch = data.tensors(args.steps, dev)
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
                                device=dev)
            trace_file = os.path.join(args.metrics_dir,
                                      f"trace_{sched}.json")
            save_chrome_trace(st, trace_file)
            obs.emit("stage_trace", schedule=sched, path=trace_file,
                     total_s=st.total_s, n_stages=st.n_stages)
            print(f"stage trace ({sched}, {st.n_stages} stages, "
                  f"{st.total_s * 1e3:.3f} ms) -> {trace_file}", flush=True)

    metrics_files = None
    if args.metrics_dir:
        metrics_files = list(obs.get_sink().paths)
        obs.close()
    if args.log_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.log_json)),
                    exist_ok=True)
        rec = hist if (guards is None and not args.metrics_dir) \
            else {"history": hist}
        if args.metrics_dir:
            rec["obs"] = {"metrics_dir": args.metrics_dir,
                          "metrics_files": metrics_files,
                          "trace_file": trace_file}
        if guards is not None:
            rec.update({"guards": dict(tr.guard_state.counters),
                        "guard_events": tr.guard_state.events,
                        "lr_scale": tr.guard_state.lr_scale})
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
