#!/usr/bin/env python3
"""On-card smoke of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository's ``src/`` next to this file; imports nothing of JAX.  Phases,
each fatal on error (nothing is caught, nothing falls back to the CPU or
to a plain version):

  1. the card's name and power limit (``nvidia-smi``);
  2. build every CUDA source of the port (one ``nvcc`` each, in parallel)
     and print ``ptxas``'s registers and spills: every source must spill 0
     bytes (``expert_ffn_grouped`` and ``expert_ffn`` share
     ``ffn_tile.cuh``'s up and down kernels);
  3. hold each of the seven kernels against its plain PyTorch version on
     the card at the serving and training paths' shapes (plus a duplicate-
     slot dispatch, a partial-tile ragged FFN and bf16 cases), check the
     fp8 wire codec's bytes on the card against the CPU's, and time kernel,
     plain version, the bound (bytes at 3.35 TB/s or flops at the type's
     peak, whichever is larger) and, as a yardstick the port never calls,
     ``torch.nn.functional.rms_norm`` / ``scaled_dot_product_attention`` /
     ``torch.index_add`` / ``torch.nn.functional.embedding_bag`` (held to
     the plain combine within its tolerance first);
  4. serve full-width qwen3-moe-30b-a3b cut to 4 layers (random weights
     from a seed) through ``Engine``: 16 requests, some sharing a 32-token
     prefix, once one-shot, once with 32-token prefill chunks and once
     one-shot under the ``s1d`` schedule; each run's kernels' launch counts
     must be > 0; one-shot under ``s1d`` must give one-shot's tokens for
     every request; then once one-shot and once chunked at the drop-free
     capacity factor (n_experts / top_k), which must agree for every
     request (at the config's own factor the prefill pools' drops depend
     on the chunking, as in the JAX engine: logged, not asserted); one
     request's logits are checked against a reference forward with the
     plain versions swapped in, under both schedules;
  5. serve the same requests forward and in reversed arrival order (prefix
     cache off, so each request's prefill is the same computation in both
     runs): every request's greedy tokens must be identical;
  6. one gpt2-moe MoE layer at full width (8 x 1024 tokens) under
     baseline, s1, s2, s2h, s1d, s1_pipe, s2_pipe (2 chunks) and s1g:
     bitwise equal to each other (the grouped kernel runs the dense
     path's FMA chains), within 1e-4 of the same layer with the plain
     versions; each schedule's forward timed;
  7. train full-width qwen3-moe-30b-a3b cut to 4 layers, batch 1 x 2048
     ``SyntheticLM`` tokens: the first step taken twice from the same
     parameters, AdamW state and batch must give ``torch.equal`` parameters
     and moments (no deterministic flag, no ``CUBLAS_WORKSPACE_CONFIG``),
     and the first step of ``make_guarded_train_step`` (lr_scale 1.0,
     grad_fault 0.0, the fp8 monitor on) from the same seed must give
     ``torch.equal`` parameters, moments and step counter and the same
     loss bits as the plain step; loss and gradient norm of one step with
     the kernels against one with the plain versions from the same
     parameters, then AdamW steps through ``Trainer``: every loss finite,
     the last three below the first, launches per step as predicted;
     under the default schedule (s1g, 10 steps) and under s1g with the
     fp8 wire (5 steps);
  8. the same for gpt2-moe at its full size (12 layers), batch 8 x 1024,
     5 steps, under the default schedule and under s1 with 2 chunks
     (layernorm: no rmsnorm launches);
  9. guarded training: gpt2-moe at full width cut to 4 layers (2 MoE
     layers; checkpoints of both moments are 1.6 GB, not 12 layers' 3.9),
     batch 8 x 1024, s1g with the fp8 wire, checkpoints in a temporary
     directory.  (a) ``nan_grad@step=3-5;ckpt_bitflip@save=2``, max_skips
     2, a snapshot every 2 steps, 2 retained, 10 steps: the exact counters
     and events (the NaN cotangents saturate the fp8 encodes, so the fp8
     fallback fires at step 3; the rollback at step 4 skips the corrupt
     step-2 file and restores step 0), a finite last loss;
     (b) save, one step, restore in place, the same step again: ``torch.
     equal``, with each save's and restore's seconds and GB/s; (c)
     ``fp8_sat@factor=64``: the fallback fires after step 0, the ragged
     path (dispatch, ``expert_ffn_ragged``, combine) launches in step 0
     only and ``expert_ffn_grouped`` from step 1 on, each at the per-layer
     counts of phases 7 and 8, every loss finite; (d) ms per step of the
     plain and the guarded clean loop and the guarded loop with a
     telemetry sink, three runs each, in turns;
 10. serving under faults, deadlines and sheds, and the telemetry; (a)-(e)
     run right after phase 5 on its model and prompts (prefix cache off,
     one request per prefill call; phase 5's forward run is the fault-free
     reference): (a) ``PHASE10_FAULTS`` with a 6-round watchdog: request 1
     expired by its tick budget, request 2 evicted by the watchdog, the
     other 14 phase 5's tokens exactly, the pages balanced, its launches
     the path ``serve_chaos``; (b) a 1e-6 s deadline expires 3 requests;
     (c) a 2-block arena sheds a request for blocks beside one that
     finishes, one row with a ~0 queue SLO sheds the waiting request;
     (d) the fault-free run with the knobs on (watchdog, 60 s deadline and
     queue SLO, a JSONL sink) against the plain run, three each in turns,
     tok/s and p50/p99, every run phase 5's tokens; (e) that sink's
     events: each request's lifecycle in order, one ``decode_round`` per
     round, the rollup's p50 the quantile of the finished latencies.
     (f) rides on phase 9 (a): a sink installed, its guard events exactly
     ``GuardState.events``, ``fp8_sat`` events at step 3 with their step,
     MoE call, schedule and wire; and 9 (d) times the sink.  (g) follows
     phase 6: stage traces of its layer under s1 and s1g
     (``obs.audit.trace_schedule``'s harness, CUDA events): the plan's
     stages, a Chrome JSON that loads, the output ``torch.equal`` before
     and after the timer, per-stage ms beside phase 6's forward; their
     launches the paths ``trace_gpt2_moe_s1`` and ``trace_gpt2_moe_s1g``;
 11. the cost model and the autoscheduler: (a) ``fit_perfmodel``'s two
     fits on the card (``expert_ffn``'s rate, the one-rank wire stage's
     startup), each R^2 > 0.8, beside ``h100_model``'s data-sheet figures;
     (b) analytic decisions under both models at qwen3's decode pool, its
     prefill buckets and 1 x 2048 training layer and gpt2-moe's 8 x 1024:
     each ``s1g`` x1 f32; (c) measured decisions at gpt2-moe's layer,
     qwen3's training layer and its decode pool: every candidate finite,
     printed sorted beside phase 6's forward times, a second ``decide``
     the same object with no launch (paths ``autosched_measure_*``); (d)
     gpt2-moe (12 layers, 8 x 1024) trained 3 steps under
     ``autosched="measured"`` and an ``auto`` wire with a sink: parameters
     and moments ``torch.equal`` to the run forced to the pick, the same
     ``moe_call`` state per step and fp8 counts, one
     ``autosched_decision`` event (path ``train_gpt2_moe_measured``); (e)
     (right after phase 10 (a)-(e)) phase 4's model and 16 requests served
     one-shot under ``autosched="measured"``: phase 4's tokens, the
     decisions printed (path ``serve_measured``); (f) the schedule audit
     of gpt2-moe's layer under s1, s2 and s1g with the fitted model:
     per-stage predicted and measured ms, ``worst``, ``time_scale``; (g)
     ``suggest_max_batch`` for phase 4's serving under both models, and
     the serve launcher with ``--max-batch 0``;
 12. print the kernels' JSON line (each kernel's launches on its main path
     and the phase-3 row at that path's shapes, and under ``by_path``
     every path's launches beside the phase-3 row at that path's shapes),
     then ``{"ok": true, ...}`` as the last line.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {"torch.float32": 67e12, "torch.bfloat16": 989e12}
N_LAYERS = 4
#: sources whose every kernel instance must spill 0 bytes (ptxas -v)
NO_SPILL = ("flash_attention", "expert_ffn_grouped", "rmsnorm",
            "moe_dispatch", "expert_ffn")


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes, flops, dtype):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def compare(name, got, want, tol):
    """Max |got - want|; fails unless it is <= tol * max(1, max|want|)."""
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    if not err <= tol * scale:       # also catches NaN
        raise AssertionError(f"{name}: max_abs_err {err:.3e} > "
                             f"{tol:.1e} * {scale:.3g}")
    return err


# --- phase 3: kernels against their plain versions --------------------------

def check_rmsnorm(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import rmsnorm_ref
    from repro_torch.kernels.rmsnorm import rmsnorm
    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    # (label, rows, dtype, tol): f32 differs by rounding and rsqrt ulps;
    # bf16 output may differ by one bf16 ulp (2^-8 relative).
    for label, R, dt, tol in (("decode", 8, torch.float32, 1e-5),
                              ("prefill128", 128, torch.float32, 1e-5),
                              ("prefill128-bf16", 128, torch.bfloat16, 1e-2),
                              ("train-qwen3", 2048, torch.float32, 1e-5)):
        D = 2048
        x = torch.randn((R, D), generator=g, device=dev).to(dt)
        scale = 1.0 + 0.1 * torch.randn((D,), generator=g, device=dev)
        err = compare(f"rmsnorm[{label}]", rmsnorm(x, scale, eps=1e-6),
                      rmsnorm_ref(x, scale, 1e-6), tol)
        ms = time_ms(lambda: rmsnorm(x, scale, eps=1e-6))
        plain = time_ms(lambda: rmsnorm_ref(x, scale, 1e-6))
        lib = time_ms(lambda: F.rms_norm(x, (D,), weight=scale.to(dt),
                                         eps=1e-6))
        es = x.element_size()
        b_ms, b_by = bound(2 * R * D * es + D * 4, 4 * R * D, dt)
        log(f"  rmsnorm[{label}] ({R}, {D}) {dt}: max_abs_err {err:.3e} "
            f"(tol {tol:.0e}) kernel {ms:.4f} ms  plain {plain:.4f} ms  "
            f"F.rms_norm {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        rows.append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    return rows


def check_grouped(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.gating import topk_gate
    from repro_torch.core.moe import shard_pool_capacity
    from repro_torch.kernels.expert_ffn_grouped import (expert_ffn_grouped,
                                                        slot_rows)
    from repro_torch.kernels.ref import expert_ffn_grouped_ref
    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev).mul_(scale)

    weights_of = {}

    def arch_weights(arch):
        """(MoEConfig, f32 weights, gate weight) of ``arch``, made once."""
        if arch not in weights_of:
            mcfg = get_config(arch).moe
            E, M, F = mcfg.n_experts, mcfg.d_model, mcfg.d_ff
            w = {"w1": randn(E, M, F, scale=M ** -0.5),
                 "w3": randn(E, M, F, scale=M ** -0.5),
                 "w2": randn(E, F, M, scale=F ** -0.5)}
            weights_of[arch] = (mcfg, w, randn(M, E, scale=M ** -0.5))
        return weights_of[arch]

    rows = []
    # (label, arch, tokens, infer, x dtype, bf16 weights, glu, act, wire,
    # tol): f32 sums of up to 3072 products in another order than cuBLAS's;
    # a bf16 output or bf16 wire rounding may differ by one bf16 ulp.  The
    # serving shapes first, then the two training steps' (phases 6 and 7:
    # all tokens of a step, the training capacity, each model's experts).
    q3, g2 = "qwen3-moe-30b-a3b", "gpt2-moe"
    f32, bf16 = torch.float32, torch.bfloat16
    cases = (("decode", q3, 8, True, f32, False, True, "silu", "f32", 1e-4),
             ("prefill128", q3, 128, False, f32, False, True, "silu", "f32",
              1e-4),
             ("decode-bf16", q3, 8, True, bf16, True, True, "silu", "f32",
              1e-2),
             ("decode-wire-bf16", q3, 8, True, f32, False, True, "silu",
              "bf16", 1e-2),
             ("decode-gelu-2layer", q3, 8, True, f32, False, False, "gelu",
              "f32", 1e-4),
             ("train-qwen3", q3, 2048, False, f32, False, True, "silu",
              "f32", 1e-4),
             ("train-gpt2-moe", g2, 8192, False, f32, False, False, "silu",
              "f32", 1e-4),
             ("train-gpt2-moe-wire-bf16", g2, 8192, False, f32, False, False,
              "silu", "bf16", 1e-2))
    for label, arch, S, infer, dt, wbf, glu, act, wire, tol in cases:
        mcfg, w, wg = arch_weights(arch)
        if label.startswith("train-") and (glu, act) != (mcfg.glu, mcfg.act):
            raise AssertionError(f"{label}: not {arch}'s expert FFN")
        E, M, F, k = mcfg.n_experts, mcfg.d_model, mcfg.d_ff, mcfg.top_k
        ws = {key: v.to(bf16) for key, v in w.items()} if wbf else w
        _, cap = shard_pool_capacity(S, 1, 1, mcfg.gate_config(),
                                     infer=infer)
        x = randn(S, M)
        r = topk_gate(x, wg, mcfg.gate_config(), cap)
        flat, weights = r.flat(cap, E), r.weights
        x = x.to(dt)
        w3 = ws["w3"] if glu else None

        def run_kernel():
            return expert_ffn_grouped(x, flat, weights, ws["w1"], w3,
                                      ws["w2"], cap=cap, act=act, wire=wire)

        def run_plain():
            return expert_ffn_grouped_ref(x, flat, weights, ws["w1"], w3,
                                          ws["w2"], cap=cap, act=act,
                                          wire=wire)

        err = compare(f"expert_ffn_grouped[{label}]", run_kernel(),
                      run_plain(), tol)
        ms = time_ms(run_kernel)
        plain = time_ms(run_plain, iters=5)
        _, counts = slot_rows(flat, S, E, cap)
        routed = int(counts.sum())
        hit = int((counts > 0).sum())
        n_mat = 3 if glu else 2
        wes, es = ws["w1"].element_size(), x.element_size()
        nbytes = (2 * S * M * es + 2 * S * k * 4
                  + hit * n_mat * M * F * wes)
        flops = 2 * n_mat * routed * M * F
        b_ms, b_by = bound(nbytes, flops, dt)
        log(f"  expert_ffn_grouped[{label}] S={S} k={k} E={E} M={M} F={F} "
            f"cap={cap} {dt} act={act} glu={glu} wire={wire}: routed rows "
            f"{routed}, hit experts {hit}; max_abs_err {err:.3e} (tol "
            f"{tol:.0e}) kernel {ms:.4f} ms  plain {plain:.4f} ms  bound "
            f"{b_ms:.4f} ms ({b_by})")
        rows.append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))
    return rows


def check_flash(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator(device=dev).manual_seed(3)
    rows = []
    # (label, B, L, H, K, hd, dtype, causal, window, tol): the two training
    # shapes, a window narrower than L, non-causal, bf16.  f32: sums of up
    # to 2048 terms in another order, and the online softmax's per-tile
    # rescaling; bf16 output: one bf16 ulp.
    cases = (("qwen3", 1, 2048, 32, 4, 128, torch.float32, True, None, 5e-5),
             ("gpt2-moe", 8, 1024, 12, 12, 64, torch.float32, True, None,
              5e-5),
             ("window256", 2, 1024, 8, 2, 128, torch.float32, True, 256,
              5e-5),
             ("non-causal", 2, 512, 12, 12, 64, torch.float32, False, None,
              5e-5),
             ("qwen3-bf16", 1, 2048, 32, 4, 128, torch.bfloat16, True, None,
              2e-2))
    for label, B, L, H, K, hd, dt, causal, window, tol in cases:
        q = torch.randn((B, L, H, hd), generator=g, device=dev).to(dt)
        k = torch.randn((B, L, K, hd), generator=g, device=dev).to(dt)
        v = torch.randn((B, L, K, hd), generator=g, device=dev).to(dt)
        kw = dict(causal=causal, window=window, scale=hd ** -0.5)
        err = compare(f"flash_attention[{label}]",
                      flash_attention(q, k, v, **kw),
                      flash_attention_plain(q, k, v, **kw), tol)
        ms = time_ms(lambda: flash_attention(q, k, v, **kw))
        plain = time_ms(lambda: flash_attention_plain(q, k, v, **kw),
                        iters=5)
        # the yardstick, on (B, H, L, hd) copies made outside the timing
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pos = torch.arange(L, device=dev)
        d = pos[:, None] - pos[None, :]
        mask = None
        if window is not None:
            mask = (d >= 0) & (d < window) if causal else d < window
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            scale=hd ** -0.5, enable_gqa=True))
        # the (query, key) pairs this data needs: causal rows see q + 1
        # keys, windowed rows at most ``window``
        seen = torch.full((L,), L, device=dev)
        if causal:
            seen = pos + 1
        if window is not None:
            seen = torch.clamp(seen, max=window)
        pairs = int(seen.sum()) * B * H
        es = q.element_size()
        b_ms, b_by = bound(B * (2 * L * H + 2 * L * K) * hd * es,
                           4 * pairs * hd, dt)
        log(f"  flash_attention[{label}] B={B} L={L} H={H} K={K} hd={hd} "
            f"{dt} causal={causal} window={window}: max_abs_err {err:.3e} "
            f"(tol {tol:.0e}) kernel {ms:.4f} ms  plain {plain:.4f} ms  "
            f"sdpa {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        rows.append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    return rows


def _gate_case(g, dev, arch, S, infer):
    """(MoEConfig, x, gate result, cap) for ``S`` random tokens of
    ``arch`` at the capacity its path uses."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.gating import topk_gate
    from repro_torch.core.moe import shard_pool_capacity
    mcfg = get_config(arch).moe
    E, M = mcfg.n_experts, mcfg.d_model
    _, cap = shard_pool_capacity(S, 1, 1, mcfg.gate_config(), infer=infer)
    x = torch.randn((S, M), generator=g, device=dev)
    wg = torch.randn((M, E), generator=g, device=dev).mul_(M ** -0.5)
    return mcfg, x, topk_gate(x, wg, mcfg.gate_config(), cap), cap


def check_dispatch_combine(dev):
    """moe_dispatch and moe_combine at the paths' shapes: serving decode
    (s1d), the qwen3 and gpt2-moe training steps, bf16, and a dispatch
    whose every odd token shares its even neighbour's first slot."""
    import torch
    from repro_torch.kernels.moe_dispatch import moe_combine, moe_dispatch
    from repro_torch.kernels.ref import moe_combine_ref, moe_dispatch_ref
    g = torch.Generator(device=dev).manual_seed(4)
    q3, g2 = "qwen3-moe-30b-a3b", "gpt2-moe"
    f32, bf16 = torch.float32, torch.bfloat16
    disp, comb = [], []
    # (label, arch, tokens, infer, dtype, duplicates).  Tolerances: dispatch
    # 0 (each slot receives at most one value: 0 + v == v), duplicates 0
    # too (the kernel and the plain version's sorted index_put_ both sum
    # in token order);
    # combine 1e-6 in f32 (k terms in choice order against cuBLAS's), bf16
    # one ulp (2e-2).
    for label, arch, S, infer, dt, dup in (
            ("decode", q3, 8, True, f32, False),
            ("train-qwen3", q3, 2048, False, f32, False),
            ("train-gpt2-moe", g2, 8192, False, f32, False),
            ("train-gpt2-moe-bf16", g2, 8192, False, bf16, False),
            ("duplicates", g2, 8192, False, f32, True)):
        mcfg, x, r, cap = _gate_case(g, dev, arch, S, infer)
        E, M, k = mcfg.n_experts, mcfg.d_model, mcfg.top_k
        n = E * cap
        flat, w = r.flat(cap, E), r.weights
        if dup:
            flat = flat.clone()
            flat[1::2, 0] = flat[0::2, 0]
        x = x.to(dt)
        es = x.element_size()
        tol = 0.0
        err = compare(f"moe_dispatch[{label}]", moe_dispatch(x, flat, n),
                      moe_dispatch_ref(x, flat, n), tol)
        ms = time_ms(lambda: moe_dispatch(x, flat, n))
        plain = time_ms(lambda: moe_dispatch_ref(x, flat, n))
        src = x[:, None].expand(S, k, M).reshape(S * k, M)
        idx = flat.reshape(-1).long()
        # the same function in one call: zeros made once, outside the
        # timing, and never written (index_add returns a new tensor)
        zeros = torch.zeros((n + 1, M), dtype=dt, device=dev)
        lib = time_ms(lambda: torch.index_add(zeros, 0, idx, src))
        b_ms, b_by = bound(S * M * es + S * k * 4 + n * M * es, S * k * M,
                           dt)
        log(f"  moe_dispatch[{label}] S={S} k={k} M={M} n_slots={n} {dt}: "
            f"max_abs_err {err:.3e} (tol {tol:.0e}) kernel {ms:.4f} ms  "
            f"plain {plain:.4f} ms  torch.index_add {lib:.4f} ms  bound "
            f"{b_ms:.4f} ms ({b_by})")
        disp.append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib))
        if dup:
            continue
        buf = torch.randn((n, M), generator=g, device=dev).to(dt)
        tol = 1e-6 if dt == f32 else 2e-2
        err = compare(f"moe_combine[{label}]", moe_combine(buf, flat, w),
                      moe_combine_ref(buf, flat, w), tol)
        ms = time_ms(lambda: moe_combine(buf, flat, w))
        plain = time_ms(lambda: moe_combine_ref(buf, flat, w))
        # the same function in one call: bags of k rows, the indices
        # clamped to n - 1 and the dropped choices' weights 0, as the
        # plain version does (its inputs made once, outside the timing)
        bag = flat.long().clamp(max=n - 1)
        bag_w = torch.where(flat < n, w, torch.zeros_like(w)).to(dt)
        err_lib = compare(
            f"F.embedding_bag[{label}]",
            torch.nn.functional.embedding_bag(
                bag, buf, per_sample_weights=bag_w, mode="sum"),
            moe_combine_ref(buf, flat, w), tol)
        lib = time_ms(lambda: torch.nn.functional.embedding_bag(
            bag, buf, per_sample_weights=bag_w, mode="sum"))
        kept = int((flat < n).sum())
        b_ms, b_by = bound(kept * M * es + S * k * 8 + S * M * es,
                           2 * kept * M, dt)
        log(f"  moe_combine[{label}] S={S} k={k} M={M} kept {kept} {dt}: "
            f"max_abs_err {err:.3e} (tol {tol:.0e}) kernel {ms:.4f} ms  "
            f"plain {plain:.4f} ms  F.embedding_bag {lib:.4f} ms "
            f"(max_abs_err {err_lib:.3e})  bound {b_ms:.4f} ms ({b_by})")
        comb.append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    return disp, comb


def check_expert_ffn(dev):
    """expert_ffn at the paths' shapes: s1d serving decode (qwen3, SwiGLU),
    qwen3's training capacity buffer (the measured calibration's
    candidates, phase 11) and gpt2-moe's, whole and as one of two chunks
    (two-layer silu).  Tolerance 1e-4: f32 sums of up to 3072
    products in another order than cuBLAS's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.moe import shard_pool_capacity
    from repro_torch.kernels.expert_ffn import expert_ffn
    from repro_torch.kernels.ref import expert_ffn_ref
    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for label, arch, S, infer, n_chunks in (
            ("decode", "qwen3-moe-30b-a3b", 8, True, 1),
            ("train-qwen3", "qwen3-moe-30b-a3b", 2048, False, 1),
            ("train-gpt2-moe", "gpt2-moe", 8192, False, 1),
            ("train-gpt2-moe-chunk", "gpt2-moe", 8192, False, 2)):
        mcfg = get_config(arch).moe
        E, M, F = mcfg.n_experts, mcfg.d_model, mcfg.d_ff
        _, cap = shard_pool_capacity(S, 1, 1, mcfg.gate_config(),
                                     infer=infer)
        T = cap // n_chunks
        x = torch.randn((E, T, M), generator=g, device=dev)
        w1 = torch.randn((E, M, F), generator=g, device=dev).mul_(M ** -0.5)
        w3 = torch.randn((E, M, F), generator=g, device=dev).mul_(
            M ** -0.5) if mcfg.glu else None
        w2 = torch.randn((E, F, M), generator=g, device=dev).mul_(F ** -0.5)
        act = mcfg.act
        err = compare(f"expert_ffn[{label}]",
                      expert_ffn(x, w1, w3, w2, act=act),
                      expert_ffn_ref(x, w1, w3, w2, act=act), 1e-4)
        ms = time_ms(lambda: expert_ffn(x, w1, w3, w2, act=act))
        plain = time_ms(lambda: expert_ffn_ref(x, w1, w3, w2, act=act),
                        iters=5)
        n_mat = 3 if mcfg.glu else 2
        b_ms, b_by = bound(2 * E * T * M * 4 + n_mat * E * M * F * 4,
                           2 * n_mat * E * T * M * F, torch.float32)
        log(f"  expert_ffn[{label}] E={E} T={T} M={M} F={F} glu="
            f"{mcfg.glu} act={act}: max_abs_err {err:.3e} (tol 1e-4) "
            f"kernel {ms:.4f} ms  plain {plain:.4f} ms  (no single PyTorch "
            f"call)  bound {b_ms:.4f} ms ({b_by})")
        rows.append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))
        del x, w1, w3, w2
    return rows


def check_ragged(dev):
    """expert_ffn_ragged at the s1g + fp8 training steps (one group, counts
    min(load, cap) of a random gate): qwen3's (E 128, cap 160, SwiGLU), with
    counts that cut 16-row tiles and on a bf16 pool, and gpt2-moe's (E 8,
    8192 tokens, two-layer silu; phase 9).  Tolerance 1e-4 (f32, as
    expert_ffn; bf16 output one ulp, 2e-2); rows at or past a count must be
    exactly 0."""
    import torch
    g = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for arch, S, cases in (
            ("qwen3-moe-30b-a3b", 2048, (
                ("train-qwen3-fp8", "gate", torch.float32, 1e-4),
                ("partial", "partial", torch.float32, 1e-4),
                ("train-qwen3-fp8-bf16", "gate", torch.bfloat16, 2e-2))),
            ("gpt2-moe", 8192, (
                ("train-gpt2-moe-fp8", "gate", torch.float32, 1e-4),))):
        rows += _ragged_rows(g, dev, arch, S, cases)
    return rows


def _ragged_rows(g, dev, arch, S, cases):
    import torch
    from repro_torch.kernels.expert_ffn_grouped import expert_ffn_ragged
    from repro_torch.kernels.ref import expert_ffn_ragged_ref
    mcfg, _, r, cap = _gate_case(g, dev, arch, S, False)
    E, M, F = mcfg.n_experts, mcfg.d_model, mcfg.d_ff
    w1, w3 = (torch.randn((E, M, F), generator=g, device=dev).mul_(M ** -0.5)
              for _ in range(2))
    if not mcfg.glu:
        w3 = None
    w2 = torch.randn((E, F, M), generator=g, device=dev).mul_(F ** -0.5)
    n_mat = 3 if mcfg.glu else 2
    act = mcfg.act
    counts_of = {
        "gate": torch.clamp(r.aux["load"], max=float(cap)).to(
            torch.int32)[:, None].contiguous(),
        "partial": torch.randint(0, 41, (E, 1), generator=g, device=dev,
                                 dtype=torch.int32)}
    rows = []
    for label, kind, dt, tol in cases:
        counts = counts_of[kind]
        xb = torch.randn((E, 1, cap, M), generator=g, device=dev).to(dt)
        got = expert_ffn_ragged(xb, counts, w1, w3, w2, act=act)
        err = compare(f"expert_ffn_ragged[{label}]", got,
                      expert_ffn_ragged_ref(xb, counts, w1, w3, w2, act=act),
                      tol)
        tail = torch.arange(cap, device=dev)[None, None, :] \
            >= counts[:, :, None]
        if not bool((got[tail] == 0).all()):
            raise AssertionError(f"expert_ffn_ragged[{label}]: a row past "
                                 f"its count is not exactly 0")
        ms = time_ms(lambda: expert_ffn_ragged(xb, counts, w1, w3, w2,
                                               act=act))
        plain = time_ms(lambda: expert_ffn_ragged_ref(xb, counts, w1, w3,
                                                      w2, act=act), iters=5)
        routed = int(counts.sum())
        hit = int((counts > 0).sum())
        es = xb.element_size()
        b_ms, b_by = bound(routed * M * es + E * cap * M * es + E * 4
                           + hit * n_mat * M * F * 4,
                           2 * n_mat * routed * M * F, torch.float32)
        log(f"  expert_ffn_ragged[{label}] E={E} G=1 c={cap} M={M} F={F} "
            f"glu={mcfg.glu} act={act} "
            f"{dt}: routed rows {routed}, hit experts {hit}; max_abs_err "
            f"{err:.3e} (tol {tol:.0e}), tail rows exactly 0; kernel "
            f"{ms:.4f} ms  plain {plain:.4f} ms  (no single PyTorch call)  "
            f"bound {b_ms:.4f} ms ({b_by})")
        rows.append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))
    return rows


def check_codec(dev):
    """The fp8 wire codec on the card (``cat`` and ``view`` of fp8
    tensors): bytes equal to the CPU's for the same input, and the round
    trip's time at qwen3's s1g + fp8 pool (128 x 160 rows of 2048)."""
    import torch
    from repro_torch.core.collectives import (CommConfig, wire_decode,
                                              wire_encode, wire_roundtrip)
    comm = CommConfig(wire_dtype="fp8_e4m3")
    x = torch.randn((1024, 2048), device=dev)
    x[3] *= 1e3
    enc = wire_encode(x, comm)
    ne = enc.view(torch.uint8).cpu() != wire_encode(x.cpu(), comm).view(
        torch.uint8)
    if ne.any():
        raise AssertionError(
            f"fp8 wire_encode: {int(ne[:, :-4].sum())} payload and "
            f"{int(ne[:, -4:].sum())} scale-tail bytes on the card differ "
            f"from the CPU's")
    if not torch.equal(wire_decode(enc, comm, torch.float32).cpu(),
                       wire_decode(enc.cpu(), comm, torch.float32)):
        raise AssertionError("fp8 wire_decode differs from the CPU's")
    pool = torch.randn((128 * 160, 2048), device=dev)
    ms = time_ms(lambda: wire_roundtrip(pool, comm))
    log(f"  fp8 wire codec: bytes on the card equal the CPU's; round trip "
        f"of a (20480, 2048) f32 pool {ms:.4f} ms")
    return ms


def check_schedules(dev):
    """Phase 6: one gpt2-moe MoE layer at full width under the one-rank
    schedules, s1g included: bitwise equal to each other, within 1e-4 of
    the plain versions; each schedule's forward timed (no grad)."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.moe import apply_moe, init_moe_params
    cfg = get_config("gpt2-moe").moe
    params = init_moe_params(torch.Generator(device=dev).manual_seed(7), cfg)
    x = torch.randn((8, 1024, cfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(8),
                    device=dev)
    outs, times = {}, {}
    runs = (("baseline", 1), ("s1", 1), ("s2", 1), ("s2h", 1), ("s1d", 1),
            ("s1_pipe", 2), ("s2_pipe", 2), ("s1g", 1))
    with torch.no_grad():
        for sched, n in runs:
            c = replace(cfg, schedule=sched, pipeline_chunks=n)
            outs[sched], aux = apply_moe(x, params, cfg=c)
            times[sched] = time_ms(lambda: apply_moe(x, params, cfg=c),
                                   iters=5)
        with plain_ops():
            plain, _ = apply_moe(x, params, cfg=replace(cfg, schedule="s1"))
    want = outs["baseline"]
    bad = [sch for sch, _ in runs if not torch.equal(outs[sch], want)]
    if bad:
        raise AssertionError(f"phase 6: {bad} differ bitwise from baseline")
    err_p = compare("phase 6: kernels vs plain versions", want, plain, 1e-4)
    log(f"  gpt2-moe MoE layer, 8 x 1024 tokens, drop fraction "
        f"{float(aux['drop_frac']):.4f}: {', '.join(s for s, _ in runs)}"
        f" bitwise equal; plain versions max_abs_err {err_p:.3e} (tol "
        f"1e-4); forward ms "
        + " ".join(f"{s} {t:.3f}" for s, t in times.items()))
    return times


# --- phases 4 and 5: serving ------------------------------------------------

def make_requests(vocab, n=16, prefix_len=32, seed=0):
    """``n`` prompts of 4..128 tokens; every third starts with one shared
    ``prefix_len``-token prefix."""
    import numpy as np
    rng = np.random.RandomState(seed)
    prefix = list(rng.randint(0, vocab, prefix_len))
    reqs = []
    for i in range(n):
        if i % 3 == 0:
            tail = rng.randint(1, 129 - prefix_len)
            prompt = prefix + list(rng.randint(0, vocab, tail))
        else:
            prompt = list(rng.randint(0, vocab, rng.randint(4, 129)))
        reqs.append(prompt)
    return reqs


def serve(model, params, prompts, *, gen, order=None, deadline=0.0,
          **engine_kw):
    """Serve ``prompts`` (submitted in ``order``, each with ``deadline``)
    and return (completions by rid, engine, wall seconds)."""
    import torch
    from repro_torch.serve import Engine
    eng = Engine(model, max_batch=8, max_len=256, block_size=16, **engine_kw)
    for i in (order if order is not None else range(len(prompts))):
        eng.submit(prompts[i], gen, rid=i, deadline=deadline)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(params)
    wall = time.perf_counter() - t0
    return {c.rid: c for c in done}, eng, wall


@contextlib.contextmanager
def plain_ops():
    """Swap the plain PyTorch versions in behind ``get_op`` (the reference
    forward of phase 4, the plain layer of phase 6 and the reference steps
    of phases 7 and 8 only)."""
    from repro_torch.kernels import registry
    saved = dict(registry._OPS)
    registry._OPS.update(registry.PLAIN)
    try:
        yield
    finally:
        registry._OPS.clear()
        registry._OPS.update(saved)


def reference_check(model, params, prompt, schedule=None):
    """Last-position logits of one one-shot prefill under ``schedule``,
    kernels vs plain versions, on fresh arenas.  f32 throughout; tolerance
    1e-3 of the logits' scale (4 layers of f32 sums in different
    orders)."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import prefill_bucket
    L = len(prompt)
    lb = prefill_bucket([L], 256)
    toks = np.zeros((1, lb), np.int32)
    toks[0, :L] = prompt
    nb = -(-lb // 16)
    batch = {"tokens": torch.from_numpy(toks).to(model.device),
             "starts": torch.zeros(1, dtype=torch.int32, device=model.device),
             "lens": torch.tensor([L], dtype=torch.int32, device=model.device),
             "tables": torch.arange(1, nb + 1, dtype=torch.int32,
                                    device=model.device)[None]}
    out = []
    for ctx in (contextlib.nullcontext(), plain_ops()):
        with ctx, torch.no_grad():
            logits, _ = model.paged_step(params, model.init_cache(nb + 1, 16),
                                         batch, schedule=schedule,
                                         infer=False)
        out.append(logits)
    err = compare("paged_step logits (kernels vs plain)", out[0], out[1],
                  1e-3)
    same = bool(torch.equal(out[0].argmax(-1), out[1].argmax(-1)))
    if not same:
        raise AssertionError("greedy token differs between kernels and "
                             "plain versions")
    return err


def serve_report(label, done, eng, wall, n_requests, gen):
    from repro_torch.serve import latency_stats
    if len(done) != n_requests:
        raise AssertionError(f"{label}: {len(done)} of {n_requests} done")
    for c in done.values():
        if len(c.tokens) != gen or not all(
                0 <= t < eng.model.cfg.vocab_size for t in c.tokens):
            raise AssertionError(f"{label}: request {c.rid} returned "
                                 f"{c.tokens}")
    st = latency_stats(done.values())
    s = eng.stats
    log(f"  {label}: {st['n_tokens']} tokens in {wall:.3f} s: "
        f"{st['tok_per_s']:.1f} tok/s  p50 {st['p50_ms']:.1f} ms  "
        f"p99 {st['p99_ms']:.1f} ms  ttft p50 {st['ttft_p50_ms']:.1f} ms  "
        f"p99 {st['ttft_p99_ms']:.1f} ms; {s['prefill_calls']} prefill "
        f"calls, {s['decode_calls']} decode rounds, prefix hits "
        f"{s['prefix_hits']} ({s['prefix_tokens']} tokens)")
    return st


# --- phases 6 and 7: training ----------------------------------------------

def kernel_wrappers():
    from repro_torch.kernels.expert_ffn import expert_ffn
    from repro_torch.kernels.expert_ffn_grouped import (expert_ffn_grouped,
                                                        expert_ffn_ragged)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_dispatch import moe_combine, moe_dispatch
    from repro_torch.kernels.rmsnorm import rmsnorm
    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
            "expert_ffn_grouped": expert_ffn_grouped,
            "moe_dispatch": moe_dispatch, "moe_combine": moe_combine,
            "expert_ffn": expert_ffn, "expert_ffn_ragged": expert_ffn_ragged}


def reset_counts():
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def read_counts(wrappers):
    return {name: fn.launches for name, fn in wrappers.items()}


def reference_step(model, params, batch, schedule=None, grad_rtol=1e-3):
    """Loss and gradient norm of one step (no update), with the kernels and
    with the plain versions, from the same parameters.  Loss within 1e-4
    relative, gradient norm within ``grad_rtol`` (1e-3): f32 throughout,
    but the kernels' forwards sum in other orders than the plain versions'
    and the routing of a near tie may flip."""
    import torch
    from repro_torch.optim.adamw import global_norm, leaves
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    out = []
    for ctx in (contextlib.nullcontext(), plain_ops()):
        with ctx:
            loss, _ = model.loss(params, batch, schedule=schedule)
            grads = torch.autograd.grad(loss, flat)
            out.append((loss.item(), global_norm(grads).item()))
            del grads, loss
    (lk, gk), (lp, gp) = out
    if not (abs(lk - lp) <= 1e-4 * abs(lp) and abs(gk - gp) <= grad_rtol * gp):
        raise AssertionError(f"loss {lk} / grad norm {gk} with the kernels, "
                             f"{lp} / {gp} with the plain versions")
    return out


def train(label, cfg, dev, *, batch, seq, steps, lr, uses, schedule=None,
          per_step=None, grad_rtol=1e-3):
    """Phases 7 and 8: ``reference_step``, then ``steps`` AdamW steps
    through ``Trainer`` under ``schedule`` with the kernels' counts set to 0
    just before.  Every kernel in ``uses`` must launch; ``per_step`` maps
    kernels to their predicted launches per step, which must hold exactly.
    Returns the launches of the run by kernel."""
    import math

    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.determinism import first_steps
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import (disable_fp8_monitor, enable_fp8_monitor,
                                     reset_fp8_counter)
    from repro_torch.train import Trainer, make_guarded_train_step
    model = Model(cfg, device=dev)
    tr = Trainer(model, AdamWConfig(lr=lr, warmup_steps=2,
                                    total_steps=steps), schedule=schedule)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch))
    # the first step twice from one state: bitwise, with no deterministic
    # flag and no CUBLAS_WORKSPACE_CONFIG (the backward sums in order); and
    # the guarded step on the clean path: bitwise the plain one
    guarded = make_guarded_train_step(model, tr.opt_cfg, schedule)

    def guarded_clean(params, opt_state, batch):
        enable_fp8_monitor()
        try:
            return guarded(params, opt_state, batch, 1.0, 0.0)
        finally:
            disable_fp8_monitor()
            reset_fp8_counter()

    bad, bad_guarded = first_steps(tr, data.tensors(0, dev), [
        tr.train_step, tr.train_step, guarded_clean])
    if bad:
        raise AssertionError(f"{label}: the first step taken twice from "
                             f"the same state differs in tensors {bad} of "
                             f"the parameters, AdamW moments, step and "
                             f"loss")
    if bad_guarded:
        raise AssertionError(f"{label}: the guarded first step (lr_scale "
                             f"1.0, grad_fault 0.0) differs from the plain "
                             f"one in tensors {bad_guarded} of the "
                             f"parameters, AdamW moments, step and loss")
    params, opt_state = tr.setup(torch.Generator(device=dev).manual_seed(0))
    n_leaves = len(_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"  {label}: {cfg.name}, {cfg.n_layers} layers, {n_bytes / 1e9:.2f} "
        f"GB of parameters, batch {batch} x {seq} tokens, remat "
        f"{cfg.remat}, schedule {schedule or cfg.moe.schedule}, "
        f"{cfg.moe.pipeline_chunks} chunk(s), wire {cfg.moe.comm.wire_dtype}")
    (lk, gk), (lp, gp) = reference_step(model, params, data.tensors(0, dev),
                                        schedule, grad_rtol)
    log(f"  {label}: one step from the same parameters: loss {lk:.6f} "
        f"(kernels) vs {lp:.6f} (plain), grad norm {gk:.6f} vs {gp:.6f}; "
        f"the first step taken twice, and once guarded (lr_scale 1.0, "
        f"grad_fault 0.0, fp8 monitor on): all {3 * n_leaves} parameter "
        f"and moment tensors, the step counter and the loss torch.equal")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = reset_counts()
    params, opt_state, hist = tr.run(params, opt_state, data, steps,
                                     log_every=1)
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in hist]
    step_ms = (hist[-1]["wall_s"] - hist[0]["wall_s"]) / (steps - 1) * 1e3
    log(f"  {label}: {steps} steps, losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; {step_ms:.1f} ms/step and "
        f"{batch * seq / step_ms * 1e3:.1f} tokens/s after the first step; "
        f"peak device memory {peak:.2f} GB; launches per step "
        f"{ {k: v / steps for k, v in launches.items()} }")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss in {losses}")
    if not sum(losses[-3:]) / 3 < losses[0]:
        raise AssertionError(f"{label}: loss did not fall: {losses}")
    if any(launches[name] <= 0 for name in uses):
        raise AssertionError(f"{label}: a kernel of the path was never "
                             f"launched: {launches}")
    for name, n in (per_step or {}).items():
        if launches[name] != n * steps:
            raise AssertionError(f"{label}: {launches[name]} {name} "
                                 f"launches in {steps} steps, predicted "
                                 f"{n} per step")
    del params, opt_state, tr, model
    torch.cuda.empty_cache()
    return launches


# --- phase 9: guarded training -----------------------------------------------

#: phase 9 (a): the plan, and the guard events it must give as (kind, step,
#: streak, restored step): skips at 3 and 4 (max_skips 2), the fp8
#: fallback at step 3 (the NaN cotangents saturate the backward's fp8
#: encodes), a rollback at 4 past the bit-flipped step-2 snapshot to step
#: 0, a skip at 5; tests/test_torch_runtime.py pins the same list against
#: the JAX package on the CPU
PHASE9_FAULTS = "nan_grad@step=3-5;ckpt_bitflip@save=2"
PHASE9_EVENTS = [("skip", 3, 1, None), ("fp8_fallback", None, None, None),
                 ("skip", 4, 2, None), ("rollback", 4, None, 0),
                 ("skip", 5, 1, None)]
PHASE9_COUNTERS = {"steps": 10, "skipped": 3, "rollbacks": 1,
                   "loss_spikes": 0, "fp8_fallbacks": 1,
                   "rollback_unavailable": 0}


def _state_tensors(params, opt_state):
    return (_leaves(params) + _leaves(opt_state["mu"])
            + _leaves(opt_state["nu"]) + [opt_state["step"]])


def guarded_training(dev, g2, fp8_per_layer, grouped_per_layer):
    """Phase 9 (see the module docstring).  ``fp8_per_layer`` maps the
    ragged path's kernels to their launches per MoE layer and step (phase
    7's qwen3 s1g + fp8 run), ``grouped_per_layer`` is
    ``expert_ffn_grouped``'s (phase 8's gpt2-moe run).  Returns the
    launches of the (a) and (c) runs by kernel, as two paths."""
    import math
    import tempfile
    from dataclasses import replace

    import torch
    from repro_torch import obs
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core import autosched, collectives
    from repro_torch.core.collectives import CommConfig
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.obs.sink import read_events
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import (FaultPlan, GuardConfig,
                                     disable_fp8_monitor, reset_fp8_counter)
    from repro_torch.train import Trainer

    cfg = replace(g2, n_layers=4, moe=replace(
        g2.moe, comm=CommConfig(wire_dtype="fp8_e4m3")))
    n_moe = sum(n for kind, n in cfg.runs() if "moe" in kind)
    model = Model(cfg, device=dev)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=1024,
                                  global_batch=8))
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)

    def trainer(**kw):
        tr = Trainer(model, opt, schedule="s1g", **kw)
        return (tr, *tr.setup(torch.Generator(device=dev).manual_seed(0)))

    def reset_globals():
        autosched.set_wire_ceiling(None)
        collectives.set_fp8_sat_injection(0.0)
        disable_fp8_monitor()
        reset_fp8_counter()

    def state_bytes(params, opt_state):
        return sum(t.numel() * t.element_size()
                   for t in _state_tensors(params, opt_state))

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the faulted run
        tr, params, opt_state = trainer(
            ckpt_path=os.path.join(tmp, "run.npz"),
            guards=GuardConfig(max_skips=2),
            faults=FaultPlan.parse(PHASE9_FAULTS), ckpt_retain=2)
        p_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        s_bytes = state_bytes(params, opt_state)
        log(f"  {cfg.name}, {cfg.n_layers} layers ({n_moe} MoE), s1g, wire "
            f"fp8_e4m3, batch 8 x 1024: {p_bytes / 1e9:.3f} GB of "
            f"parameters, {s_bytes / 1e9:.3f} GB per snapshot with both "
            f"moments; faults {PHASE9_FAULTS}")
        # phase 10 (f): the same run with a telemetry sink installed
        obs.configure(os.path.join(tmp, "metrics"), meta={"phase": "9 (a)"})
        wrappers = reset_counts()
        try:
            params, opt_state, hist = tr.run(params, opt_state, data, 10,
                                             log_every=1, ckpt_every=2)
            torch.cuda.synchronize()
            metrics = obs.get_sink().paths
        finally:
            obs.close()
        launches["train_gpt2_moe_guarded_s1g_fp8"] = read_counts(wrappers)
        gs, mgr = tr.guard_state, tr.rollback_mgr
        events = [(e["kind"], e.get("step"), e.get("streak"),
                   e.get("restored_step")) for e in gs.events]
        if events != PHASE9_EVENTS or gs.counters != PHASE9_COUNTERS:
            raise AssertionError(f"phase 9 (a): events {gs.events}, "
                                 f"counters {gs.counters}")
        snaps = [(e["kind"], e["step"]) for e in mgr.events]
        restored = [e for e in mgr.events if e["kind"] == "rollback"]
        if (snaps != [("snapshot", 0), ("snapshot", 2), ("rollback", 4),
                      ("snapshot", 6), ("snapshot", 8)]
                or not restored[0]["path"].endswith("run.step00000000.npz")
                or mgr.store.steps() != [6, 8]):
            raise AssertionError(f"phase 9 (a): the store's history "
                                 f"{mgr.events}, retained "
                                 f"{mgr.store.steps()}")
        losses = [h["loss"] for h in hist]
        if not math.isfinite(losses[-1]) or [
                i for i, x in enumerate(losses) if not math.isfinite(x)] \
                != [3, 4, 5]:
            raise AssertionError(f"phase 9 (a): losses {losses}")
        log(f"  (a) 10 steps: losses {' '.join(f'{x:.4f}' for x in losses)}"
            f"; events {gs.events}; {gs.summary()}; the rollback at step 4 "
            f"skipped the corrupt step-2 snapshot and restored step 0; "
            f"retained {mgr.store.steps()}; launches "
            f"{ {k: v for k, v in read_counts(wrappers).items() if v} }")
        evs = read_events(metrics)
        got = []
        for e in evs:
            if e["event"] in ("guard_skip", "guard_rollback"):
                got.append((e["event"], e["step"],
                            e["streak"] if e["event"] == "guard_skip"
                            else e["restored_step"])
                           + ((e["lr_scale"],)
                              if e["event"] == "guard_skip" else ()))
            elif e["event"] == "fp8_fallback":
                got.append((e["event"], e["sat_rate"], e["wire"]))
        sat3 = [e for e in evs if e["event"] == "fp8_sat"
                and e["step"] == 3]
        # moe_call counts the step's MoE calls: each block's recompute in
        # the backward (remat) is a call of its own
        if got != sink_guard_events(gs.events) or not sat3 or not all(
                (0 <= e["moe_call"] < 2 * n_moe and e["schedule"] == "s1g"
                 and e["wire"] == "fp8_e4m3") for e in sat3):
            raise AssertionError(f"phase 10 (f): sink events {got}, "
                                 f"expected {sink_guard_events(gs.events)}; "
                                 f"step-3 fp8_sat events {sat3}")
        log(f"  phase 10 (f) the same run with a sink: {len(evs)} events, "
            f"the guard events exactly GuardState.events' ({got}); "
            f"{len(sat3)} fp8_sat events at step 3, e.g. "
            f"{ {k: sat3[0][k] for k in ('step', 'moe_call', 'schedule', 'wire', 'sat', 'total')} }"
            f"; fp8_sat events by step "
            f"{ {s: sum(e['step'] == s for e in evs if e['event'] == 'fp8_sat') for s in range(10)} }")
        reset_globals()

        # (b) save -> restore in place -> one more step, bitwise
        path = os.path.join(tmp, "b.npz")
        live = {"params": params, "opt_state": opt_state}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(path, live, 10)
        t_save = time.perf_counter() - t0
        batch = data.tensors(10, dev)
        ptrs = [t.data_ptr() for t in _state_tensors(params, opt_state)]
        params, opt_state, m = tr.train_step(params, opt_state, batch)
        want = [t.detach().to("cpu") for t in
                _state_tensors(params, opt_state)] + [m["loss"].cpu()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, step = load_checkpoint(path, into=live)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        params, opt_state, m = tr.train_step(params, opt_state, batch)
        got = _state_tensors(params, opt_state) + [m["loss"]]
        bad = [i for i, (a, b) in enumerate(zip(want, got))
               if not torch.equal(a, b.detach().to("cpu"))]
        if step != 10 or bad or ptrs != [
                t.data_ptr() for t in _state_tensors(params, opt_state)]:
            raise AssertionError(f"phase 9 (b): restored step {step}; "
                                 f"tensors {bad} differ after the round "
                                 f"trip, or a tensor moved")
        gb = s_bytes / 1e9
        log(f"  (b) save {t_save:.3f} s ({gb / t_save:.2f} GB/s), restore "
            f"in place {t_restore:.3f} s ({gb / t_restore:.2f} GB/s; "
            f"two reads of the file: crc check, then copy_) of "
            f"{gb:.3f} GB ({os.path.getsize(path) / 1e9:.3f} GB on disk); "
            f"one more step after the round trip: all {len(want)} "
            f"tensors and the loss torch.equal, every tensor in place")
        del tr, params, opt_state, live, want, got, m
        torch.cuda.empty_cache()

    # (c) injected fp8 saturation: the ragged path in step 0, then the
    # fused grouped kernel on the bf16 wire
    tr, params, opt_state = trainer(guards=GuardConfig(),
                                    faults=FaultPlan.parse(
                                        "fp8_sat@factor=64"))
    wrappers = reset_counts()
    per_step, inner = [], tr.guarded_step

    def counted(*args):
        before = read_counts(wrappers)
        out = inner(*args)
        after = read_counts(wrappers)
        per_step.append({k: after[k] - before[k] for k in after})
        return out

    tr.guarded_step = counted
    params, opt_state, hist = tr.run(params, opt_state, data, 4,
                                     log_every=1)
    torch.cuda.synchronize()
    launches["train_gpt2_moe_fp8_fallback"] = read_counts(wrappers)
    gs = tr.guard_state
    ragged = {k: n * n_moe for k, n in fp8_per_layer.items()}
    first = {**ragged, "expert_ffn_grouped": 0}
    later = {**{k: 0 for k in ragged},
             "expert_ffn_grouped": grouped_per_layer * n_moe}
    seen = [{k: c[k] for k in first} for c in per_step]
    losses = [h["loss"] for h in hist]
    if ([e["kind"] for e in gs.events] != ["fp8_fallback"]
            or autosched.wire_ceiling() != "bf16"
            or seen != [first] + [later] * 3
            or not all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"phase 9 (c): events {gs.events}, ceiling "
                             f"{autosched.wire_ceiling()}, launches per "
                             f"step {seen} (predicted {first} in step 0, "
                             f"{later} after), losses {losses}")
    log(f"  (c) fp8_sat@factor=64: {gs.events[0]}; launches per step "
        f"{seen} (predicted from phases 7 and 8); losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}")
    reset_globals()
    del tr, params, opt_state
    torch.cuda.empty_cache()

    # (d) the guarded clean loop against the plain one, and (phase 10 (f))
    # the guarded loop with a telemetry sink, in turns (the host is shared:
    # step times move between runs, so three of each, each side first as
    # often)
    times, steps = [], 8
    with tempfile.TemporaryDirectory() as tmp:
        for i, side in enumerate(("plain", "guarded", "sink", "sink",
                                  "guarded", "plain", "plain", "sink",
                                  "guarded")):
            tr, params, opt_state = trainer(
                guards=None if side == "plain" else GuardConfig())
            if side == "sink":
                obs.configure(os.path.join(tmp, str(i)))
            try:
                hist = tr.run(params, opt_state, data, steps,
                              log_every=1)[2]
                torch.cuda.synchronize()
            finally:
                obs.close()
            ms = (hist[-1]["wall_s"] - hist[0]["wall_s"]) / (steps - 1) * 1e3
            times.append((side, ms, hist[-1]["loss"]))
            reset_globals()
            del tr, params, opt_state, hist
            torch.cuda.empty_cache()
    if len({loss for _, _, loss in times}) != 1:
        raise AssertionError(f"phase 9 (d): the plain, guarded and sink "
                             f"clean runs end on different losses: {times}")
    med = {side: sorted(ms for label, ms, _ in times if label == side)[1]
           for side in ("plain", "guarded", "sink")}
    log(f"  (d) ms/step after the first step ({steps} steps, each step's "
        f"loss read), in turns: "
        + ", ".join(f"{label} {ms:.2f}" for label, ms, _ in times)
        + f"; medians plain {med['plain']:.2f}, guarded "
        f"{med['guarded']:.2f} ({med['guarded'] / med['plain'] - 1:+.2%}), "
        f"guarded with a sink {med['sink']:.2f} "
        f"({med['sink'] / med['guarded'] - 1:+.2%} over guarded); the same "
        f"last loss bits")
    return launches


# --- phase 10: serving under faults and deadlines, and the telemetry -------

#: phase 10 (a): rid 1 force-expired after 4 ticks, rid 2 stalled into the
#: watchdog (6 rounds), every free arena block held hostage for 8 ticks
PHASE10_FAULTS = ("req_timeout@rid=1,ticks=4;req_delay@rid=2,rounds=999;"
                  "alloc_starve@tick=1,hold=9999,rounds=8")
LIFECYCLE = ["req_queued", "req_admitted", "req_prefilled", "req_finished"]


def _balanced(eng, label):
    """The allocator's ledger balances and no page is live."""
    eng.pool.alloc_blocks.check()
    if eng.pool.n_live:
        raise AssertionError(f"{label}: {eng.pool.n_live} pages still live")


def serve_robustness(model, params, prompts, gen, want):
    """Phase 10 (a)-(e) (see the module docstring).  ``want`` is phase 5's
    forward run (prefix cache off, one request per prefill call), the
    fault-free reference.  Returns (a)'s launches by kernel."""
    import tempfile

    import torch
    from repro_torch import obs
    from repro_torch.obs.registry import quantile
    from repro_torch.obs.sink import read_events
    from repro_torch.runtime import FaultPlan
    from repro_torch.serve import Engine, latency_stats
    n = len(prompts)

    # (a) the chaos plan: two requests cut, the other 14 bitwise
    wrappers = reset_counts()
    done, eng, wall = serve(model, params, prompts, gen=gen,
                            prefix_cache=False, watchdog_rounds=6,
                            faults=FaultPlan.parse(PHASE10_FAULTS))
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    cut = {rid: (c.status, c.reason, len(c.tokens))
           for rid, c in done.items() if c.status != "ok"}
    bad = [i for i in range(n) if i not in (1, 2)
           and (done[i].status, done[i].tokens) != ("ok", want[i].tokens)]
    if (sorted(done) != list(range(n)) or sorted(cut) != [1, 2]
            or cut[1][0] != "expired" or "tick" not in cut[1][1]
            or cut[2][0] != "evicted" or "watchdog" not in cut[2][1]
            or bad or eng.stats["expired"] != 1
            or eng.stats["evicted"] != 1):
        raise AssertionError(f"phase 10 (a): cut {cut}, requests {bad} "
                             f"differ from the fault-free run, stats "
                             f"{eng.stats}")
    for rid in (1, 2):
        if done[rid].tokens != want[rid].tokens[:len(done[rid].tokens)]:
            raise AssertionError(f"phase 10 (a): request {rid}'s partial "
                                 f"stream is not a prefix of its own")
    _balanced(eng, "phase 10 (a)")
    if min(launches[k] for k in ("rmsnorm", "expert_ffn_grouped")) <= 0:
        raise AssertionError(f"phase 10 (a): a kernel of the path was never "
                             f"launched: {launches}")
    log(f"  (a) {PHASE10_FAULTS}, watchdog 6 rounds: {cut}; the other "
        f"{n - 2} requests' tokens equal phase 5's; {eng.stats['expired']} "
        f"expired, {eng.stats['evicted']} evicted, {eng.stats['decode_calls']}"
        f" decode rounds in {wall:.3f} s; pages balance; launches "
        f"{ {k: v for k, v in launches.items() if v} }")

    # (b) a deadline at its extreme expires every request mid-flight
    eng = Engine(model, max_batch=8, max_len=256, block_size=16,
                 prefix_cache=False)
    for i in range(3):
        eng.submit(prompts[i], gen, rid=i, deadline=1e-6)
    got = [(c.status, c.reason) for c in eng.run(params)]
    if len(got) != 3 or any(st != "expired" or not r.startswith("deadline")
                            for st, r in got):
        raise AssertionError(f"phase 10 (b): {got}")
    _balanced(eng, "phase 10 (b)")
    log(f"  (b) 3 requests with a 1e-6 s deadline: {got[0][0]} "
        f"({got[0][1]}) x 3; pages balance")

    # (c) the sheds: a request no arena of 2 blocks can hold, and one that
    # waits past a ~0 queue SLO behind a pinned-full pool
    eng = Engine(model, max_batch=2, max_len=64, n_blocks=2, block_size=16)
    eng.submit(list(range(1, 7)), 40)
    eng.submit(list(range(1, 7)), 4)
    c0, c1 = eng.run(params)
    _balanced(eng, "phase 10 (c)")
    slo = Engine(model, max_batch=1, max_len=256, block_size=16,
                 prefix_cache=False, queue_slo=1e-6)
    slo.submit(prompts[0], 8)
    slo.submit(prompts[1], 8)
    q0, q1 = slo.run(params)
    _balanced(slo, "phase 10 (c)")
    if ((c0.status, c1.status, len(c1.tokens)) != ("shed", "ok", 4)
            or not c0.reason.startswith("blocks")
            or eng.stats["shed_blocks"] != 1
            or (q0.status, q1.status) != ("ok", "shed")
            or not q1.reason.startswith("queue")
            or slo.stats["shed_queue"] != 1):
        raise AssertionError(f"phase 10 (c): {c0}, {c1}, {q0}, {q1}")
    log(f"  (c) 2-block arena: shed ({c0.reason}), the small request beside "
        f"it ok with {len(c1.tokens)} tokens; one row and a 1e-6 s queue "
        f"SLO: shed ({q1.reason}); pages balance")

    # (d) the knobs' cost: watchdog, a 60 s deadline on every request, a
    # 60 s queue SLO and a JSONL sink, against the plain run, in turns
    runs, events, n_bytes = [], None, 0
    with tempfile.TemporaryDirectory() as tmp:
        for i, knobs in enumerate((False, True, True, False, False, True)):
            kw = dict(prefix_cache=False)
            if knobs:
                obs.configure(os.path.join(tmp, str(i)), meta={
                    "kind": "serve", "phase": "10 (d)"})
                kw.update(watchdog_rounds=6, queue_slo=60.0, deadline=60.0)
            try:
                done, eng, wall = serve(model, params, prompts, gen=gen,
                                        **kw)
                paths = obs.get_sink().paths if knobs else None
            finally:
                obs.close()
            st = latency_stats(done.values())
            runs.append(("knobs" if knobs else "plain", st["tok_per_s"],
                         st["p50_ms"], st["p99_ms"]))
            bad = [r for r in range(n) if (done[r].status, done[r].tokens)
                   != ("ok", want[r].tokens)]
            if bad:
                raise AssertionError(f"phase 10 (d): requests {bad} differ "
                                     f"from the fault-free run")
            if knobs:
                events = read_events(paths)
                n_bytes = sum(os.path.getsize(p) for p in paths)
                stats = dict(eng.stats)
    med = {side: [sorted(r[j] for r in runs if r[0] == side)[1]
                  for j in (1, 2, 3)] for side in ("plain", "knobs")}
    log("  (d) in turns: " + ", ".join(
        f"{side} {tps:.1f} tok/s p50 {p50:.1f} p99 {p99:.1f} ms"
        for side, tps, p50, p99 in runs)
        + f"; medians plain {med['plain'][0]:.1f} tok/s p50 "
        f"{med['plain'][1]:.1f} p99 {med['plain'][2]:.1f} ms, knobs "
        f"{med['knobs'][0]:.1f} tok/s p50 {med['knobs'][1]:.1f} p99 "
        f"{med['knobs'][2]:.1f} ms ({med['knobs'][0] / med['plain'][0] - 1:+.2%}"
        f" tok/s); all six runs give phase 5's tokens")

    # (e) the last knobs run's event stream
    per_rid = {}
    for e in events:
        if e["event"].startswith("req_"):
            per_rid.setdefault(e["rid"], []).append(e["event"])
    rounds = sum(e["event"] == "decode_round" for e in events)
    lats = sorted(e["latency_s"] for e in events
                  if e["event"] == "req_finished")
    roll = [e for e in events if e["event"] == "serve_rollup"]
    if (sorted(per_rid) != list(range(n))
            or any(v != LIFECYCLE for v in per_rid.values())
            or rounds != stats["decode_calls"] or len(roll) != 1
            or roll[0]["latency_s.p50"] != quantile(lats, 50)):
        raise AssertionError(f"phase 10 (e): lifecycles {per_rid}, "
                             f"{rounds} decode_round events for "
                             f"{stats['decode_calls']} rounds, rollup {roll}")
    log(f"  (e) {len(events)} events, {n_bytes} bytes: every request "
        f"{' -> '.join(LIFECYCLE)}; {rounds} decode_round events = decode "
        f"rounds; serve_rollup latency_s.p50 {roll[0]['latency_s.p50']:.4f} "
        f"s = quantile of the {len(lats)} finished latencies")
    # the sink's own host cost: an event into the buffer, and one write of
    # a full buffer (64 events, the sink's default) to the file
    from repro_torch.obs.sink import JsonlSink
    with tempfile.TemporaryDirectory() as tmp:
        sink = JsonlSink(tmp, buffer_events=1 << 30)
        t_emit, t_flush = [], []
        for _ in range(20):
            t0 = time.perf_counter()
            for i in range(64):
                sink.emit("decode_round", tick=i, rows=8, active=8,
                          block_occupancy=0.25)
            t1 = time.perf_counter()
            sink.flush()
            t_emit.append((t1 - t0) / 64)
            t_flush.append(time.perf_counter() - t1)
        sink.close()
    log(f"  (e) the sink under {tempfile.gettempdir()}: "
        f"{sorted(t_emit)[10] * 1e6:.1f} us an event (median of 20 x 64), "
        f"{sorted(t_flush)[10] * 1e3:.3f} ms a write of 64 (median; max "
        f"{max(t_flush) * 1e3:.3f})")
    return launches


def sink_guard_events(gs_events):
    """The guard events a sink receives for ``GuardState.events``: a skip
    that fills the streak is recorded by the rollback it triggers."""
    out = []
    for i, e in enumerate(gs_events):
        nxt = gs_events[i + 1] if i + 1 < len(gs_events) else {}
        if e["kind"] == "skip" and not (nxt.get("kind") == "rollback"
                                        and nxt["step"] == e["step"]):
            out.append(("guard_skip", e["step"], e["streak"],
                        e["lr_scale"]))
        elif e["kind"] == "rollback":
            out.append(("guard_rollback", e["step"], e["restored_step"]))
        elif e["kind"] == "fp8_fallback":
            out.append(("fp8_fallback", e["sat_rate"], e["wire"]))
    return out


def stage_traces(dev, forward_ms):
    """Phase 10 (g): stage traces of phase 6's gpt2-moe MoE layer (8 x 1024
    tokens) under s1 and s1g through ``trace_schedule``'s harness; the
    stage names are the plan's validated order, the Chrome JSON loads, and
    the full plan after the timer is bitwise ``apply_moe`` before and after
    it.  Returns each trace's launches as a path."""
    import tempfile
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import executor
    from repro_torch.core import plan as planlib
    from repro_torch.core.moe import apply_moe
    from repro_torch.obs.audit import _LayerHarness
    from repro_torch.obs.trace import save_chrome_trace
    cfg = get_config("gpt2-moe").moe
    h = _LayerHarness(cfg, 8 * 1024, seed=7, device=dev)
    x = h.x.view(8, 1024, cfg.d_model)
    launches = {}
    for sched in ("s1", "s1g"):
        c = replace(cfg, schedule=sched)
        plan = planlib.build_plan(sched, h.info())
        with torch.no_grad():
            before, _ = apply_moe(x, h.params, cfg=c)
            wrappers = reset_counts()
            st = h.trace(sched)
            torch.cuda.synchronize()
            launches[f"trace_gpt2_moe_{sched}"] = read_counts(wrappers)
            full, _ = executor.execute(plan, *h.args, h.info())
            after, _ = apply_moe(x, h.params, cfg=c)
        names = [s.name for s in planlib.validate(plan)]
        with tempfile.TemporaryDirectory() as tmp:
            doc = json.load(open(save_chrome_trace(
                st, os.path.join(tmp, "trace.json"))))
        slices = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
        if ([s.name for s in st.stages] != names or slices != names
                or not torch.equal(before.view(-1, cfg.d_model), full)
                or not torch.equal(before, after)):
            raise AssertionError(f"phase 10 (g) {sched}: stages "
                                 f"{[s.name for s in st.stages]}, plan "
                                 f"{names}, Chrome slices {slices}, or the "
                                 f"outputs moved")
        log(f"  (g) {sched}: " + ", ".join(
            f"{s.name} ({s.kind}) {s.measured_s * 1e3:.3f}"
            for s in st.stages)
            + f" ms; prefix 0 {st.overhead_s * 1e3:.3f} ms, full plan "
            f"{st.total_s * 1e3:.3f} ms (phase 6's forward "
            f"{forward_ms[sched]:.3f} ms); Chrome JSON loads; the output "
            f"torch.equal before and after the timer; launches "
            f"{ {k: v for k, v in launches[f'trace_gpt2_moe_{sched}'].items() if v} }")
    return launches


# --- phase 11: the cost model and the autoscheduler -------------------------

def serve_measured(model, params, prompts, gen, want):
    """Phase 11 (e): phase 4's model and prompts served one-shot under
    ``autosched="measured"`` (every prefill bucket and the decode pool
    calibrated on the card once): every request's tokens phase 4's
    one-shot run's (``want``).  Returns the run's launches by kernel."""
    from dataclasses import replace

    from repro_torch.core import autosched
    from repro_torch.models import Model
    cfg = model.cfg
    measured = Model(replace(cfg, moe=replace(cfg.moe, autosched="measured")),
                     device=model.device)
    autosched.clear_cache()
    wrappers = reset_counts()
    done, eng, wall = serve(measured, params, prompts, gen=gen)
    launches = read_counts(wrappers)
    bad = [i for i in range(len(prompts)) if done[i].tokens != want[i].tokens]
    if bad:
        raise AssertionError(f"phase 11 (e): requests {bad} differ from "
                             f"phase 4's one-shot run")
    summary = autosched.cache_summary()
    if "decode]" not in summary or "autosched[measured]" not in summary:
        raise AssertionError(f"phase 11 (e): decisions {summary!r}")
    log(f"  (e) qwen3 served one-shot under autosched=measured: "
        f"{len(prompts)}/{len(prompts)} requests phase 4's tokens in "
        f"{wall:.3f} s (calibrations included); launches "
        f"{ {k: v for k, v in launches.items() if v} }; decisions:")
    for line in summary.splitlines():
        log(f"      {line}")
    autosched.clear_cache()
    return launches


def _measured_decision(cfg, dev, B, L, infer):
    """Resolve ``cfg`` (measured mode) at a (B, L) pool as ``apply_moe``
    does and return the decision it cached and its cache key."""
    from dataclasses import replace

    from repro_torch.core import autosched
    from repro_torch.core.moe import resolve_schedule
    before = set(autosched.cache_info())
    resolve_schedule(replace(cfg, autosched="measured"), B=B, L=L,
                     infer=infer, device=dev)
    (key, d), = [(k, v) for k, v in autosched.cache_info().items()
                 if k not in before]
    return key, d


def autoscheduling(dev, forward_ms, serve_cfg, prompts, gen):
    """Phase 11 (a)-(d), (f), (g) (see the module docstring).  Returns the
    measured paths' launches by kernel and the decision of (d)."""
    import math
    import tempfile
    from dataclasses import replace

    import torch
    from repro_torch import obs
    from repro_torch import runtime as trt
    from repro_torch.configs import get_config
    from repro_torch.core import autosched
    from repro_torch.core import moe as tmoe
    from repro_torch.core.collectives import CommConfig
    from repro_torch.core.moe import resolve_schedule
    from repro_torch.core.perfmodel import h100_model
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.fit_perfmodel import (measure_card,
                                                  model_from_fits, report)
    from repro_torch.models import Model
    from repro_torch.obs.audit import run_schedule_audit
    from repro_torch.obs.sink import read_events
    from repro_torch.optim import AdamWConfig
    from repro_torch.serve.engine import prefill_bucket
    from repro_torch.serve import suggest_max_batch
    from repro_torch.train import Trainer
    paths = {}

    # (a) the card's fits
    t0 = time.perf_counter()
    fits = measure_card(dev)
    fitted, sheet = model_from_fits(fits), h100_model(1, 1, 1)
    for line in report(fits, fitted):
        log(f"  (a) {line}")
    if not (fits["flops"]["r2"] > 0.8 and fits["alpha"]["r2"] > 0.8):
        raise AssertionError(f"phase 11 (a): R^2 {fits['flops']['r2']}, "
                             f"{fits['alpha']['r2']} (want > 0.8)")
    log(f"  (a) fitted: flops_per_s {fitted.flops_per_s:.6e}, collective "
        f"alpha {fitted.a2a_ep_esp.alpha:.6e} s; data sheet: "
        f"{sheet.flops_per_s:.6e}, {sheet.a2a_ep_esp.alpha:.6e} s "
        f"({time.perf_counter() - t0:.1f} s)")

    # (b) analytic decisions at every main-path shape, under both models
    q3, g2 = serve_cfg.moe, get_config("gpt2-moe").moe
    buckets = sorted({prefill_bucket([len(p)], 256) for p in prompts}
                     | {prefill_bucket([32], 256)})
    shapes = ([("qwen3 decode", q3, 8, 1, True)]
              + [(f"qwen3 prefill {b}", q3, 1, b, False) for b in buckets]
              + [("qwen3 train", q3, 1, 2048, False),
                 ("gpt2-moe train", g2, 8, 1024, False)])
    for name, pm in (("data sheet", sheet), ("fitted", fitted)):
        got = {label: resolve_schedule(c, B=B, L=L, infer=inf,
                                       perf_model=pm)
               for label, c, B, L, inf in shapes}
        bad = {k: v for k, v in got.items() if v != ("s1g", 1, "f32")}
        if bad:
            raise AssertionError(f"phase 11 (b) {name}: {bad}")
        log(f"  (b) analytic, {name} model: s1g x1 f32 at "
            + ", ".join(got))

    # (c) measured decisions
    for path, label, c, B, L, inf in (
            ("autosched_measure_gpt2_moe", "gpt2-moe 8 x 1024", g2, 8,
             1024, False),
            ("autosched_measure_qwen3_train", "qwen3 1 x 2048", q3, 1,
             2048, False),
            ("autosched_measure_qwen3_decode", "qwen3 decode 8 rows", q3, 8,
             1, True)):
        autosched.clear_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wrappers = reset_counts()
        t0 = time.perf_counter()
        key, d = _measured_decision(c, dev, B, L, inf)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        paths[path] = read_counts(wrappers)
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not all(math.isfinite(t) for _, t in d.times):
            raise AssertionError(f"phase 11 (c) {label}: {d.times}")
        wrappers = reset_counts()
        measure = autosched.measure_candidates(
            c, tokens=B * L, d_model=c.d_model, device=dev)
        again = autosched.decide(key[0], perf_model=key[3],
                                 mode="measured", chunk_candidates=key[2],
                                 wire_candidates=key[4], measure=measure)
        resolve_schedule(replace(c, autosched="measured"), B=B, L=L,
                         infer=inf, device=dev)
        if again is not d or any(read_counts(wrappers).values()):
            raise AssertionError(f"phase 11 (c) {label}: the second "
                                 f"decide calibrated again")
        fwd = (" (phase 6's forward ms: " + " ".join(
            f"{k} {v:.3f}" for k, v in forward_ms.items()) + ")"
            if c is g2 else "")
        log(f"  (c) measured {label}: {len(d.times)} candidates in "
            f"{secs:.2f} s, peak device memory {peak:.2f} GB; pick "
            f"{d.schedule} x{d.n_chunks} {d.wire_dtype}; median ms "
            + " ".join(f"{'/'.join(map(str, cand))} {t * 1e3:.3f}"
                       for cand, t in d.times) + fwd)
    autosched.clear_cache()

    # (d) gpt2-moe trained under measured mode and an auto wire, with a
    # sink; then from the same seed forced to its pick
    auto = replace(g2, autosched="measured",
                   comm=CommConfig(wire_dtype="auto"))
    full = replace(get_config("gpt2-moe"), moe=auto)
    data = SyntheticLM(DataConfig(vocab_size=full.vocab_size, seq_len=1024,
                                  global_batch=8))
    runs = {}

    def run(cfg, label):
        model = Model(cfg, device=dev)
        tr = Trainer(model, AdamWConfig(lr=1e-3, warmup_steps=2,
                                        total_steps=3))
        params, opt_state = tr.setup(
            torch.Generator(device=dev).manual_seed(0))
        calls, step = [], tr.train_step

        def counted(*a):
            out = step(*a)
            calls.append(dict(tmoe._CALLS))
            return out
        tr.train_step = counted
        trt.reset_fp8_counter()
        with tempfile.TemporaryDirectory() as tmp:
            obs.configure(tmp, meta={"phase": f"11 (d) {label}"})
            try:
                wrappers = reset_counts()
                params, opt_state, hist = tr.run(params, opt_state, data, 3,
                                                 log_every=1)
                torch.cuda.synchronize()
                launches = read_counts(wrappers)
                obs.flush()
                events = read_events(obs.get_sink().paths)
            finally:
                obs.close()
        runs[label] = dict(state=_state_tensors(params, opt_state),
                           calls=calls, sat=trt.fp8_sat_counts(),
                           events=events, launches=launches,
                           losses=[h["loss"] for h in hist])
        del model, tr, params, opt_state
        torch.cuda.empty_cache()

    autosched.clear_cache()
    t0 = time.perf_counter()
    run(full, "measured")
    (key, d), = autosched.cache_info().items()
    autosched.clear_cache()
    forced = replace(full, moe=replace(
        g2, schedule=d.schedule, pipeline_chunks=d.n_chunks,
        comm=CommConfig(wire_dtype=d.wire_dtype)))
    run(forced, "forced")
    m, f = runs["measured"], runs["forced"]
    same = [i for i, (a, b) in enumerate(zip(m["state"], f["state"]))
            if not torch.equal(a, b)]
    decisions = [e for e in m["events"] if e["event"] == "autosched_decision"]
    if (same or len(m["state"]) != len(f["state"])
            or m["calls"] != f["calls"] or m["sat"] != f["sat"]
            or len(decisions) != 1 or key[1] != "measured"
            or any(e["event"] == "autosched_decision" for e in f["events"])):
        raise AssertionError(
            f"phase 11 (d): tensors {same} differ, ordinals {m['calls']} vs "
            f"{f['calls']}, fp8 counts {m['sat']} vs {f['sat']}, decision "
            f"events {decisions}")
    paths["train_gpt2_moe_measured"] = m["launches"]
    log(f"  (d) gpt2-moe {full.n_layers} layers, 8 x 1024, 3 steps under "
        f"autosched=measured, wire auto: pick {d.schedule} x{d.n_chunks} "
        f"{d.wire_dtype} (from {len(d.times)} candidates); losses "
        + " ".join(f"{x:.4f}" for x in m["losses"])
        + f"; all {len(m['state'])} parameter and moment tensors torch.equal"
        f" to the run forced to the pick; moe_call state per step "
        f"{m['calls']} and fp8 counts {m['sat']} the forced run's; one "
        f"autosched_decision event ({decisions[0]['tokens']} tokens); "
        f"{time.perf_counter() - t0:.1f} s for both runs")

    # (f) the schedule audit at gpt2-moe's layer under the fitted model
    reports = run_schedule_audit(g2, 8 * 1024, perf_model=fitted,
                                 device=dev)
    for rep in reports:
        log(f"  (f) audit {rep['schedule']}: predicted/measured ms "
            + ", ".join(f"{s['name']} {s['predicted_s'] * 1e3:.3f}/"
                        f"{s['measured_s'] * 1e3:.3f}" for s in rep["stages"])
            + f"; total {rep['total_predicted_s'] * 1e3:.3f}/"
            f"{rep['total_measured_s'] * 1e3:.3f}; worst {rep['worst']}; "
            f"time_scale {rep['calibration']['time_scale']:.4f}; priced at "
            f"zero: " + ", ".join(
                f"{s['name']} {s['measured_s'] * 1e3:.3f} ms"
                for s in rep["stages"] if s["predicted_s"] == 0.0))

    # (g) the decode batch from the cost model, phase 4's serving budget
    mean_len = min((4 + 128) / 2 + gen, 256)
    picks = {name: suggest_max_batch(serve_cfg, perf_model=pm,
                                     n_blocks=8 * 256 // 16, block_size=16,
                                     mean_len=mean_len)
             for name, pm in (("data sheet", sheet), ("fitted", fitted))}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-moe-30b-a3b", "--reduced", "--smoke", "--max-batch", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    lines = [x for x in out.stdout.splitlines()
             if x.startswith(("auto max-batch", "autosched[", "SERVE"))]
    if out.returncode or "SERVE SMOKE OK" not in out.stdout:
        raise AssertionError(f"phase 11 (g): the launcher failed: "
                             f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
    log(f"  (g) suggest_max_batch for phase 4's serving (128 blocks of 16, "
        f"mean length {mean_len:g}): {picks}; the launcher with "
        f"--max-batch 0: " + " | ".join(lines))
    return paths


#: kernel -> (source, the TPU kernel it replaces, its main path, the phase-3
#: row at that path's shapes)
KERNELS = {
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:12", "train_qwen3",
                "train-qwen3"),
    "expert_ffn_grouped": ("src/repro_torch/csrc/expert_ffn_grouped.cu",
                           "src/repro/kernels/expert_ffn_grouped.py:136",
                           "train_qwen3", "train-qwen3"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:28",
                        "train_qwen3", "qwen3"),
    "moe_dispatch": ("src/repro_torch/csrc/moe_dispatch.cu",
                     "src/repro/kernels/moe_dispatch.py:22",
                     "train_gpt2_moe_s1_pipe2", "train-gpt2-moe"),
    "moe_combine": ("src/repro_torch/csrc/moe_dispatch.cu",
                    "src/repro/kernels/moe_dispatch.py:72",
                    "train_gpt2_moe_s1_pipe2", "train-gpt2-moe"),
    "expert_ffn": ("src/repro_torch/csrc/expert_ffn.cu",
                   "src/repro/kernels/expert_ffn.py:25",
                   "train_gpt2_moe_s1_pipe2", "train-gpt2-moe-chunk"),
    "expert_ffn_ragged": ("src/repro_torch/csrc/expert_ffn.cu",
                          "src/repro/kernels/expert_ffn_grouped.py:41",
                          "train_qwen3_s1g_fp8", "train-qwen3-fp8"),
}

#: (kernel, path) -> the phase-3 row at the shapes that path gives the
#: kernel (serving: decode, the shape of most of its launches); a pair not
#: listed must launch the kernel no time on that path
SHAPE_OF = {
    ("rmsnorm", "serve_one_shot"): "decode",
    ("rmsnorm", "serve_chunked_32"): "decode",
    ("rmsnorm", "serve_one_shot_s1d"): "decode",
    ("rmsnorm", "train_qwen3"): "train-qwen3",
    ("rmsnorm", "train_qwen3_s1g_fp8"): "train-qwen3",
    ("expert_ffn_grouped", "serve_one_shot"): "decode",
    ("expert_ffn_grouped", "serve_chunked_32"): "decode",
    ("expert_ffn_grouped", "train_qwen3"): "train-qwen3",
    ("expert_ffn_grouped", "train_gpt2_moe"): "train-gpt2-moe",
    ("flash_attention", "train_qwen3"): "qwen3",
    ("flash_attention", "train_qwen3_s1g_fp8"): "qwen3",
    ("flash_attention", "train_gpt2_moe"): "gpt2-moe",
    ("flash_attention", "train_gpt2_moe_s1_pipe2"): "gpt2-moe",
    ("moe_dispatch", "serve_one_shot_s1d"): "decode",
    ("moe_dispatch", "train_qwen3_s1g_fp8"): "train-qwen3",
    ("moe_dispatch", "train_gpt2_moe_s1_pipe2"): "train-gpt2-moe",
    ("moe_combine", "serve_one_shot_s1d"): "decode",
    ("moe_combine", "train_qwen3_s1g_fp8"): "train-qwen3",
    ("moe_combine", "train_gpt2_moe_s1_pipe2"): "train-gpt2-moe",
    ("expert_ffn", "serve_one_shot_s1d"): "decode",
    ("expert_ffn", "train_gpt2_moe_s1_pipe2"): "train-gpt2-moe-chunk",
    ("expert_ffn_ragged", "train_qwen3_s1g_fp8"): "train-qwen3-fp8",
}
SHAPE_OF.update({
    ("rmsnorm", "serve_chaos"): "decode",
    ("expert_ffn_grouped", "serve_chaos"): "decode",
    ("moe_dispatch", "trace_gpt2_moe_s1"): "train-gpt2-moe",
    ("moe_combine", "trace_gpt2_moe_s1"): "train-gpt2-moe",
    ("expert_ffn", "trace_gpt2_moe_s1"): "train-gpt2-moe",
    ("expert_ffn_grouped", "trace_gpt2_moe_s1g"): "train-gpt2-moe"})
# phase 11: every measured calibration runs s1g (the grouped kernel) and
# the dispatch -> expert_ffn -> combine schedules; (d) trains with flash,
# (e) serves with rmsnorm
for _path, _label in (("autosched_measure_gpt2_moe", "train-gpt2-moe"),
                      ("autosched_measure_qwen3_train", "train-qwen3"),
                      ("autosched_measure_qwen3_decode", "decode"),
                      ("train_gpt2_moe_measured", "train-gpt2-moe"),
                      ("serve_measured", "decode")):
    SHAPE_OF.update({(k, _path): _label for k in (
        "moe_dispatch", "moe_combine", "expert_ffn", "expert_ffn_grouped")})
SHAPE_OF[("flash_attention", "train_gpt2_moe_measured")] = "gpt2-moe"
SHAPE_OF[("rmsnorm", "serve_measured")] = "decode"
# phase 9's two runs: the ragged path while the wire is fp8, the fused
# grouped kernel on the bf16 wire after the fallback
for _path in ("train_gpt2_moe_guarded_s1g_fp8", "train_gpt2_moe_fp8_fallback"):
    SHAPE_OF.update({
        ("flash_attention", _path): "gpt2-moe",
        ("moe_dispatch", _path): "train-gpt2-moe",
        ("moe_combine", _path): "train-gpt2-moe",
        ("expert_ffn_ragged", _path): "train-gpt2-moe-fp8",
        ("expert_ffn_grouped", _path): "train-gpt2-moe-wire-bf16"})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this smoke runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.core.collectives import CommConfig
    from repro_torch.kernels import _build
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"phase 2: built {sorted(logs) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    spilled = []
    for name, text in logs.items():
        fn = ""
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:  # the kernel's name and template arguments, mangled
                short = re.search(r"[a-z]+(?:_[a-z]+)*_kernel(?:I\w+?EE)?",
                                  entry.group(1))
                fn = short.group(0) if short else entry.group(1)[:56]
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"  [{name}] {fn}: {line.strip()}")
            if name in NO_SPILL and any(
                    int(n) for n in re.findall(r"(\d+) bytes spill", line)):
                spilled.append(f"[{name}] {line.strip()}")
    if spilled:
        raise AssertionError("phase 2: the redesigned kernels spill: "
                             + "; ".join(spilled))

    # 3. kernels vs plain versions
    log("phase 3: kernels vs plain versions on the card")
    rows = {"rmsnorm": check_rmsnorm(dev),
            "expert_ffn_grouped": check_grouped(dev),
            "flash_attention": check_flash(dev)}
    rows["moe_dispatch"], rows["moe_combine"] = check_dispatch_combine(dev)
    rows["expert_ffn"] = check_expert_ffn(dev)
    rows["expert_ffn_ragged"] = check_ragged(dev)
    check_codec(dev)
    torch.cuda.empty_cache()

    # 4. serve full width, 4 layers
    cfg = replace(get_config("qwen3-moe-30b-a3b"), n_layers=N_LAYERS)
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size()
                  for t in _leaves(params))
    log(f"phase 4: {cfg.name} full width, {N_LAYERS} layers: "
        f"{n_bytes / 1e9:.2f} GB of parameters made on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    prompts = make_requests(cfg.vocab_size)
    gen = 32
    serve(model, params, prompts[:2], gen=4)          # warm-up (not counted)
    for sched in (None, "s1d"):
        err_ref = reference_check(model, params, prompts[0], sched)
        log(f"  reference check ({sched or 'auto'}): paged_step logits, "
            f"kernels vs plain versions: max_abs_err {err_ref:.3e}")

    runs = {}
    path_launches = {}
    for label, path, kw, uses in (
            ("one-shot", "serve_one_shot", {},
             ("rmsnorm", "expert_ffn_grouped")),
            ("chunked-32", "serve_chunked_32", {"prefill_chunk": 32},
             ("rmsnorm", "expert_ffn_grouped")),
            ("one-shot-s1d", "serve_one_shot_s1d", {"schedule": "s1d"},
             ("rmsnorm", "moe_dispatch", "expert_ffn", "moe_combine"))):
        torch.cuda.reset_peak_memory_stats()
        wrappers = reset_counts()
        done, eng, wall = serve(model, params, prompts, gen=gen, **kw)
        launches = read_counts(wrappers)
        st = serve_report(label, done, eng, wall, len(prompts), gen)
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"  {label}: peak device memory {peak:.2f} GB; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        if min(launches[name] for name in uses) <= 0:
            raise AssertionError(f"{label}: a kernel of the path was never "
                                 f"launched: {launches}")
        runs[label] = done
        path_launches[path] = launches
    # s1d runs dispatch -> expert_ffn -> combine, the grouped kernel's
    # FMA chains (phase 6 holds the two bitwise): the same tokens
    bad = [i for i in range(len(prompts))
           if runs["one-shot"][i].tokens != runs["one-shot-s1d"][i].tokens]
    if bad:
        raise AssertionError(f"phase 4: requests {bad} differ between "
                             f"one-shot serving under auto and under s1d")
    log(f"  one-shot vs one-shot-s1d: {len(prompts)}/{len(prompts)} "
        f"requests with identical tokens")
    same = sum(runs["one-shot"][i].tokens == runs["chunked-32"][i].tokens
               for i in range(len(prompts)))
    # prefill pools take the training capacity (infer=False), so which
    # rows drop depends on the chunking, in the JAX engine as here; at
    # capacity_factor = n_experts / top_k no pool can drop a row, and
    # chunked prefill must then give one-shot's tokens
    moe = cfg.moe
    free = Model(replace(cfg, moe=replace(
        moe, capacity_factor=moe.n_experts / moe.top_k)), device=dev)
    df = {label: serve(free, params, prompts, gen=gen, **kw)[0]
          for label, kw in (("one-shot", {}),
                            ("chunked-32", {"prefill_chunk": 32}))}
    bad = [i for i in range(len(prompts))
           if df["one-shot"][i].tokens != df["chunked-32"][i].tokens]
    if bad:
        raise AssertionError(f"phase 4: at drop-free capacity requests "
                             f"{bad} differ between one-shot and chunked "
                             f"prefill")
    log(f"  one-shot vs chunked-32: {same}/{len(prompts)} requests with "
        f"identical tokens at capacity_factor {moe.capacity_factor} (the "
        f"prefill pools' drops depend on the chunking, as in the JAX "
        f"engine); {len(prompts)}/{len(prompts)} at the drop-free "
        f"capacity_factor {moe.n_experts / moe.top_k:g}")
    del free, df

    # 5. determinism and batch independence
    fwd, _, _ = serve(model, params, prompts, gen=gen, prefix_cache=False)
    rev, _, _ = serve(model, params, prompts, gen=gen, prefix_cache=False,
                      order=range(len(prompts) - 1, -1, -1))
    bad = [i for i in range(len(prompts)) if fwd[i].tokens != rev[i].tokens]
    if bad:
        raise AssertionError(f"phase 5: requests {bad} differ between "
                             f"forward and reversed arrival order")
    log(f"phase 5: {len(prompts)} requests, forward vs reversed arrival "
        f"order: identical greedy tokens")

    # 10. serving under faults and deadlines (the same model and prompts;
    # phase 5's forward run is the fault-free reference)
    t0 = time.perf_counter()
    log("phase 10: serving under faults, deadlines and sheds; telemetry")
    path_launches["serve_chaos"] = serve_robustness(model, params, prompts,
                                                    gen, fwd)
    log(f"  (a)-(e) in {time.perf_counter() - t0:.1f} s")

    # 11 (e). serving under the measured autoscheduler (the same model and
    # prompts; phase 4's one-shot run is the reference)
    t0 = time.perf_counter()
    log("phase 11 (e): serving under autosched=measured")
    path_launches["serve_measured"] = serve_measured(
        model, params, prompts, gen, runs["one-shot"])
    log(f"  (e) in {time.perf_counter() - t0:.1f} s")

    del model, params, runs, fwd, rev, done, eng
    torch.cuda.empty_cache()

    # 6. the schedules on one rank, then (phase 10 (g)) the stage traces of
    # the same layer
    log("phase 6: one gpt2-moe MoE layer under every one-rank schedule")
    forward_ms = check_schedules(dev)
    torch.cuda.empty_cache()
    path_launches.update(stage_traces(dev, forward_ms))
    torch.cuda.empty_cache()

    # 7. and 8. train qwen3 (full width, 4 layers) and gpt2-moe (full
    # size), each under the default schedule and under this slice's path.
    # qwen3 at lr 1e-3 (gpt2-moe's) spikes from its router z-loss in the
    # first steps; at 1e-4 the loss falls step by step
    log(f"phase 7: train {cfg.name} full width, {N_LAYERS} layers")
    path_launches["train_qwen3"] = train(
        "qwen3", cfg, dev, batch=1, seq=2048, steps=10, lr=1e-4,
        uses=("rmsnorm", "flash_attention", "expert_ffn_grouped"),
        per_step={"rmsnorm": 17, "flash_attention": 8,
                  "expert_ffn_grouped": 8})
    # the fp8 wire turns the flash and rmsnorm kernels' last-bit
    # differences into whole e4m3 steps where a value sits at a rounding
    # boundary: the first step's gradient norm moved 2.2e-3 (loss 5.8e-5;
    # the CPU tests see the same against JAX), so it is held to 1e-2
    fp8 = replace(cfg, moe=replace(cfg.moe,
                                   comm=CommConfig(wire_dtype="fp8_e4m3")))
    fp8_steps = 5
    path_launches["train_qwen3_s1g_fp8"] = train(
        "qwen3 s1g fp8", fp8, dev, batch=1, seq=2048, steps=fp8_steps,
        lr=1e-4,
        schedule="s1g", grad_rtol=1e-2,
        uses=("moe_dispatch", "expert_ffn_ragged", "moe_combine"),
        per_step={"moe_dispatch": 12, "expert_ffn_ragged": 8,
                  "moe_combine": 8, "rmsnorm": 17, "flash_attention": 8,
                  "expert_ffn_grouped": 0, "expert_ffn": 0})
    log("phase 8: train gpt2-moe at its full size")
    g2 = get_config("gpt2-moe")
    g2_steps = 5
    path_launches["train_gpt2_moe"] = train(
        "gpt2-moe", g2, dev, batch=8, seq=1024, steps=g2_steps, lr=1e-3,
        uses=("flash_attention", "expert_ffn_grouped"),
        per_step={"flash_attention": 24, "expert_ffn_grouped": 12})
    g2s1 = replace(g2, moe=replace(g2.moe, pipeline_chunks=2))
    path_launches["train_gpt2_moe_s1_pipe2"] = train(
        "gpt2-moe s1 2 chunks", g2s1, dev, batch=8, seq=1024, steps=5,
        lr=1e-3, schedule="s1", uses=("moe_dispatch", "expert_ffn",
                                      "moe_combine"),
        per_step={"moe_dispatch": 18, "moe_combine": 12, "expert_ffn": 24,
                  "flash_attention": 24, "expert_ffn_grouped": 0,
                  "rmsnorm": 0})

    # 9. guarded training; the launch predictions per MoE layer and step
    # come from phase 7's fp8 run and phase 8's gpt2-moe run
    log("phase 9: guarded training, gpt2-moe full width, 4 layers")

    def n_moe(c):
        return sum(n for kind, n in c.runs() if "moe" in kind)

    fp8_per_layer = {
        k: path_launches["train_qwen3_s1g_fp8"][k] / (fp8_steps * n_moe(fp8))
        for k in ("moe_dispatch", "expert_ffn_ragged", "moe_combine")}
    grouped_per_layer = (path_launches["train_gpt2_moe"]["expert_ffn_grouped"]
                         / (g2_steps * n_moe(g2)))
    path_launches.update(guarded_training(dev, g2, fp8_per_layer,
                                          grouped_per_layer))
    torch.cuda.empty_cache()

    # 11. the cost model and the autoscheduler on the card ((e) ran after
    # phase 10 (a)-(e), on phase 4's model)
    t0 = time.perf_counter()
    log("phase 11: the cost model and the autoscheduler")
    path_launches.update(autoscheduling(dev, forward_ms, cfg, prompts, gen))
    log(f"  (a)-(d), (f), (g) in {time.perf_counter() - t0:.1f} s")

    # 12. results.  Each kernel's top-level numbers are those of its main
    # path (KERNELS): its launches there, counted from 0 just before the
    # run, and the phase-3 row at the shapes that path gives it.
    # ``by_path`` pairs every path's launches with the phase-3 row at that
    # path's shapes, or null where the path does not launch the kernel.
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    by_label = {name: {r["label"]: r for r in rs}
                for name, rs in rows.items()}
    kernels = []
    for name, (source, replaces, main_path, main_label) in KERNELS.items():
        by_path = {}
        for path, launches in path_launches.items():
            label = SHAPE_OF.get((name, path))
            if (launches[name] > 0) != (label is not None):
                raise AssertionError(f"{name}: {launches[name]} launches on "
                                     f"{path}, phase-3 shape {label}")
            by_path[path] = {"launches": launches[name], "shape": label,
                             **{k: by_label[name][label][k] if label
                                else None for k in keys}}
        main_row = by_label[name][main_label]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "main_path": main_path,
            "launches": path_launches[main_path][name],
            **{k: main_row[k] for k in keys}, "by_path": by_path})
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


if __name__ == "__main__":
    sys.exit(main())
