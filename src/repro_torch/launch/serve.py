"""Serving launcher of the port: continuous-batching engine over synthetic
traffic, on one CUDA card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \\
      --layers 4 --requests 16 --max-batch 8 --gen 32

The flags are the JAX launcher's for what the port's engine supports, plus
``--layers N`` (cut the depth, keep the full width) and ``--device``.
Weights are random from ``--seed``.  Without a CUDA card the launcher
stops with an error; ``--device cpu`` asks for the CPU explicitly.  TF32 is
switched off for matmuls and cuDNN: the JAX reference computes in full f32.

Robustness, as in JAX: ``--deadline`` (per request), ``--queue-slo``,
``--watchdog-rounds`` and seeded ``--faults`` (``req_timeout``,
``req_delay``, ``alloc_starve``); a run with any of them prints a
``robustness:`` line, and ``--smoke`` with ``--faults`` asserts the chaos
contract (every request comes back, some finish) and prints
``SERVE CHAOS OK``.  Telemetry: ``--metrics-dir DIR`` streams the request
lifecycle as JSONL into DIR; ``--trace`` (needs ``--metrics-dir``) times
the decode MoE schedule's plan stages and writes a Chrome trace there.
``--max-batch 0`` sizes the decode batch from the cost model
(``suggest_max_batch``: predicted decode throughput under the KV block
budget); a run ends with the autoscheduler's decisions, one
``autosched[...]`` line per layer shape (``decode`` marks the decode
pools' decisions, kept apart from the prefill buckets').
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core import autosched
from repro_torch.core.schedules import SCHEDULES
from repro_torch.launch.common import device_profile, resolve_device
from repro_torch.models import Model
from repro_torch.serve import (Engine, SamplerConfig, latency_stats,
                               suggest_max_batch)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers at full width (0 = all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="requests/s (0 = all arrive at t=0)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="decode batch / KV rows (0 = sized by the cost "
                         "model)")
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="max synthetic prompt length")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--prefill-batch", type=int, default=1)
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV page size in tokens (must divide --max-len)")
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="KV arena pages (0 = max_batch * max_len / "
                         "block_size)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill size in tokens (0 = one-shot)")
    ap.add_argument("--schedule", default=None, choices=SCHEDULES,
                    help="force one MoE schedule, run on one rank "
                         "(default: auto, which is s1g there)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request wall-clock deadline in seconds "
                         "(0 = none); blown deadlines cancel mid-flight "
                         "and free their KV pages")
    ap.add_argument("--queue-slo", type=float, default=0.0,
                    help="max seconds a request may wait in queue for "
                         "blocks before being shed (0 = backpressure only)")
    ap.add_argument("--watchdog-rounds", type=int, default=0,
                    help="evict a decode row after this many rounds "
                         "without progress (0 = off)")
    ap.add_argument("--faults", default=None,
                    help="fault-injection spec, e.g. 'req_timeout@rid=1,"
                         "ticks=4;req_delay@rid=2,rounds=99;alloc_starve@"
                         "tick=1,hold=999,rounds=8' "
                         "(repro_torch.runtime.faults)")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--log-json", default=None,
                    help="write latency + robustness stats to this file")
    ap.add_argument("--metrics-dir", default=None,
                    help="stream request-lifecycle telemetry (queued/"
                         "admitted/prefilled/finished, decode rounds, "
                         "rollups) as JSONL into this directory")
    ap.add_argument("--trace", action="store_true",
                    help="after serving, time the decode MoE schedule's "
                         "plan stages and save a Chrome trace JSON into "
                         "--metrics-dir")
    ap.add_argument("--profile", action="store_true",
                    help="warm up, serve, then serve again under "
                         "torch.profiler; print device time by kernel and "
                         "the device's busy share (CUDA only)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny run, assert clean completion")
    args = ap.parse_args(argv)
    if args.requests < 1:
        ap.error("--requests must be >= 1")
    if args.max_batch < 0:
        ap.error("--max-batch must be >= 0")
    if args.trace and not args.metrics_dir:
        ap.error("--trace requires --metrics-dir")
    if args.smoke:
        args.requests = min(args.requests, 8)
        args.gen = min(args.gen, 8)
        args.max_len = min(args.max_len, 64)
        args.prompt_len = min(args.prompt_len, 12)
    dev = resolve_device(args.device)
    if args.profile and dev.type != "cuda":
        ap.error("--profile measures the card: it needs --device cuda")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = replace(cfg, n_layers=args.layers)
    model = Model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    if args.max_batch == 0:          # cost-model bucket sizing (t_decode)
        # mean live context per row: half the prompt spread + the budget
        mean_len = min((4 + args.prompt_len) / 2 + args.gen, args.max_len)
        args.max_batch = suggest_max_batch(
            cfg, candidates=(1, 2, 4, 8, 16, 32),
            n_blocks=args.n_blocks or None, block_size=args.block_size,
            mean_len=mean_len)
        print(f"auto max-batch (t_decode, block budget): {args.max_batch}",
              flush=True)
    faults = None
    if args.faults:
        from repro_torch.runtime import FaultPlan
        faults = FaultPlan.parse(args.faults, seed=args.fault_seed)
        print(f"fault plan: {faults.summary()}", flush=True)

    def make_engine():
        return Engine(model, max_batch=args.max_batch, max_len=args.max_len,
                      schedule=args.schedule,
                      prefill_batch=args.prefill_batch,
                      block_size=args.block_size,
                      n_blocks=args.n_blocks or None,
                      prefix_cache=args.prefix_cache,
                      prefill_chunk=args.prefill_chunk,
                      queue_slo=args.queue_slo,
                      watchdog_rounds=args.watchdog_rounds, faults=faults)

    rng = np.random.RandomState(args.seed)
    sampler = SamplerConfig(temperature=args.temperature, top_k=args.top_k,
                            seed=args.seed)
    requests = [dict(prompt=rng.randint(0, cfg.vocab_size,
                                        int(rng.randint(
                                            4, max(args.prompt_len, 5)))),
                     max_new_tokens=args.gen, sampler=sampler,
                     arrival=(i / args.arrival_rate
                              if args.arrival_rate > 0 else 0.0),
                     deadline=args.deadline)
                for i in range(args.requests)]
    profile = None
    if args.profile:
        make_engine().run(params, requests)       # warm-up, not measured
    if args.metrics_dir:
        obs.configure(args.metrics_dir, meta={
            "kind": "serve", "arch": args.arch,
            "requests": args.requests, "max_batch": args.max_batch,
            "gen": args.gen, "schedule": args.schedule,
            "device": str(dev),
            "argv": sys.argv[1:] if argv is None else list(argv)})
    engine = make_engine()
    t0 = time.perf_counter()
    done = engine.run(params, requests, progress=not args.smoke)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if args.profile:
        profile = device_profile(
            lambda: make_engine().run(params, requests), wall_ms)

    stats = latency_stats(done)
    s = engine.stats
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"device: {where}; {cfg.name} with {cfg.n_layers} layers")
    print(f"served {stats['n_requests']} requests / "
          f"{stats['n_tokens']} tokens: {stats['tok_per_s']:.1f} tok/s  "
          f"p50 {stats['p50_ms']:.0f}ms  p95 {stats['p95_ms']:.0f}ms  "
          f"p99 {stats['p99_ms']:.0f}ms  "
          f"ttft_p50 {stats['ttft_p50_ms']:.0f}ms")
    print(f"engine: {s['prefill_calls']} prefill calls "
          f"({s['prefill_tokens']} tokens), {s['decode_calls']} decode "
          f"rounds ({s['decode_tokens']} tokens), max_active "
          f"{s['max_active']}/{engine.max_batch}")
    print(f"paged kv: {s['prefix_hits']} prefix hits "
          f"({s['prefix_tokens']} tokens reused), peak pages "
          f"{s['peak_blocks']}/{engine.pool.n_blocks} "
          f"(block size {engine.block_size})")
    if s["shed"] or s["expired"] or s["evicted"] or args.faults \
            or args.deadline or args.queue_slo or args.watchdog_rounds:
        print(f"robustness: {s['shed']} shed "
              f"({s['shed_blocks']} blocks, {s['shed_queue']} queue SLO), "
              f"{s['expired']} expired, {s['evicted']} evicted")
    summary = autosched.cache_summary()
    if summary:
        print(summary)
    if profile is not None:
        print(f"profile: device busy {profile['busy_ms']:.1f} ms "
              f"(profiled run) over {profile['wall_ms']:.1f} ms wall "
              f"(unprofiled run): {100 * profile['busy_share']:.1f}% busy; "
              f"{profile['n_kernels']} kernel launches")
        for title, key in (("by kernel", "top"), ("by op", "top_ops")):
            print(f" device time {title}:")
            for row in profile[key]:
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
                sched = "s1d"   # the decode-dedicated plan
            st = trace_schedule(cfg.moe, engine.max_batch, sched,
                                infer=True, device=dev)
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
        rec = {"device": where, "latency": stats, "engine": s,
               "profile": profile,
               "statuses": {c.rid: c.status for c in done}}
        if args.metrics_dir:
            rec["obs"] = {"metrics_dir": args.metrics_dir,
                          "metrics_files": metrics_files,
                          "trace_file": trace_file}
        with open(args.log_json, "w") as f:
            json.dump(rec, f, indent=1)
    ok = [c for c in done if c.status == "ok"]
    if ok:
        print("sample:", ok[0].tokens[:16])
    if args.smoke:
        # every submitted request must come back (finished, shed, expired
        # or evicted): nothing may hang or vanish
        if len(done) != args.requests or not all(c.tokens for c in ok):
            raise SystemExit("smoke: not every request completed")
        if args.faults:
            if not ok:
                raise SystemExit("chaos smoke: every request was cancelled")
            print("SERVE CHAOS OK")
        print("SERVE SMOKE OK")


if __name__ == "__main__":
    main()
