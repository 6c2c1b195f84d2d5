#!/usr/bin/env python3
"""On-card smoke of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository's ``src/`` next to this file; imports nothing of JAX.  Phases,
each fatal on error:

  1. the card's name and power limit (``nvidia-smi``);
  2. build every CUDA source of the port (one ``nvcc`` each, in parallel);
  3. hold each kernel against its plain PyTorch version on the card at the
     serving path's shapes, and time kernel, plain version, the bound
     (bytes at 3.35 TB/s or flops at the type's peak, whichever is larger)
     and, for rmsnorm, ``torch.nn.functional.rms_norm`` as a yardstick;
  4. serve full-width qwen3-moe-30b-a3b cut to 4 layers (random weights
     from a seed) through ``Engine``: 16 requests, some sharing a 32-token
     prefix, once one-shot and once with 32-token prefill chunks; both
     kernels' launch counts must be > 0; one request's logits are checked
     against a reference forward with the plain versions swapped in;
  5. serve the same requests forward and in reversed arrival order (prefix
     cache off, so each request's prefill is the same computation in both
     runs): every request's greedy tokens must be identical;
  6. print the kernels' JSON line, then ``{"ok": true, ...}`` as the last
     line.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {"torch.float32": 67e12, "torch.bfloat16": 989e12}
N_LAYERS = 4


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
                              ("prefill128-bf16", 128, torch.bfloat16, 1e-2)):
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
    mcfg = get_config("qwen3-moe-30b-a3b").moe
    gate = mcfg.gate_config()
    E, M, F, k = mcfg.n_experts, mcfg.d_model, mcfg.d_ff, mcfg.top_k
    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev).mul_(scale)

    w = {"w1": randn(E, M, F, scale=M ** -0.5),
         "w3": randn(E, M, F, scale=M ** -0.5),
         "w2": randn(E, F, M, scale=F ** -0.5)}
    wg = randn(M, E, scale=M ** -0.5)
    wbf = {key: v.to(torch.bfloat16) for key, v in w.items()}
    rows = []
    # (label, tokens, infer, x dtype, weights, glu, act, wire, tol): f32
    # sums of 2048 and 768 products in another order than cuBLAS's; a bf16
    # output or bf16 wire rounding may differ by one bf16 ulp.
    cases = (("decode", 8, True, torch.float32, w, True, "silu", "f32", 1e-4),
             ("prefill128", 128, False, torch.float32, w, True, "silu",
              "f32", 1e-4),
             ("decode-bf16", 8, True, torch.bfloat16, wbf, True, "silu",
              "f32", 1e-2),
             ("decode-wire-bf16", 8, True, torch.float32, w, True, "silu",
              "bf16", 1e-2),
             ("decode-gelu-2layer", 8, True, torch.float32, w, False, "gelu",
              "f32", 1e-4))
    for label, S, infer, dt, ws, glu, act, wire, tol in cases:
        _, cap = shard_pool_capacity(S, 1, 1, gate, infer=infer)
        x = randn(S, M)
        r = topk_gate(x, wg, gate, cap)
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


def serve(model, params, prompts, *, gen, order=None, **engine_kw):
    """Serve ``prompts`` (submitted in ``order``) and return
    (completions by rid, engine, wall seconds)."""
    import torch
    from repro_torch.serve import Engine
    eng = Engine(model, max_batch=8, max_len=256, block_size=16, **engine_kw)
    for i in (order if order is not None else range(len(prompts))):
        eng.submit(prompts[i], gen, rid=i)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(params)
    wall = time.perf_counter() - t0
    return {c.rid: c for c in done}, eng, wall


@contextlib.contextmanager
def plain_ops():
    """Swap the plain PyTorch versions in behind ``get_op`` (the reference
    forward of phase 4 only)."""
    from repro_torch.kernels import ref, registry
    saved = dict(registry._OPS)
    registry._OPS.update(rmsnorm=ref.rmsnorm_ref,
                         expert_ffn_grouped=ref.expert_ffn_grouped_ref)
    try:
        yield
    finally:
        registry._OPS.clear()
        registry._OPS.update(saved)


def reference_check(model, params, prompt):
    """Last-position logits of one one-shot prefill, kernels vs plain
    versions, on fresh arenas.  f32 throughout; tolerance 1e-3 of the
    logits' scale (4 layers of f32 sums in different orders)."""
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
                                         batch, infer=False)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this smoke runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.expert_ffn_grouped import expert_ffn_grouped
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

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
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  [{name}] {line.strip()}")

    # 3. kernels vs plain versions
    log("phase 3: kernels vs plain versions on the card")
    rms = check_rmsnorm(dev)
    grp = check_grouped(dev)

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
    err_ref = reference_check(model, params, prompts[0])
    log(f"  reference check: paged_step logits, kernels vs plain versions: "
        f"max_abs_err {err_ref:.3e}")

    runs = {}
    for label, kw in (("one-shot", {}), ("chunked-32", {"prefill_chunk": 32})):
        torch.cuda.reset_peak_memory_stats()
        rmsnorm.launches = expert_ffn_grouped.launches = 0
        done, eng, wall = serve(model, params, prompts, gen=gen, **kw)
        launches = {"rmsnorm": rmsnorm.launches,
                    "expert_ffn_grouped": expert_ffn_grouped.launches}
        st = serve_report(label, done, eng, wall, len(prompts), gen)
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"  {label}: peak device memory {peak:.2f} GB; launches "
            f"{launches}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"{label}: a kernel of the path was never "
                                 f"launched: {launches}")
        runs[label] = (done, launches, st)
    same = sum(runs["one-shot"][0][i].tokens == runs["chunked-32"][0][i].tokens
               for i in range(len(prompts)))
    log(f"  one-shot vs chunked: {same}/{len(prompts)} requests with "
        f"identical tokens (prefill capacity drops depend on the chunking)")

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

    # 6. results
    launches = runs["one-shot"][1]
    kernels = []
    for name, source, replaces, row in (
            ("rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:12", rms[0]),
            ("expert_ffn_grouped", "src/repro_torch/csrc/expert_ffn_grouped.cu",
             "src/repro/kernels/expert_ffn_grouped.py:136", grp[0])):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
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
