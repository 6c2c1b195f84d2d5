"""Event, device and host time of the port's kernels at the main paths'
shapes.

    PYTHONPATH=src python -m repro_torch.launch.kernel_times [--iters 20]
        [--kernels rmsnorm,moe_dispatch,...]

Cases, by kernel: ``expert_ffn_grouped`` (qwen3-moe-30b-a3b decode, 8
tokens; the qwen3 and gpt2-moe training steps, every slot filled),
``expert_ffn`` (qwen3's s1d decode buffer, 128 x 8 rows; one of the two
chunks of gpt2-moe's s1 step, 8 x 1232 rows), ``expert_ffn_ragged``
(qwen3's s1g + fp8 step, 128 x 160 slots),
``flash_attention`` (both training shapes), ``rmsnorm`` (decode 8 x 2048,
prefill 128 x 2048 in f32 and bf16, qwen3's training step 2048 x 2048),
``moe_dispatch`` (qwen3 decode, both training steps, gpt2-moe's in bf16,
and its step with every odd token sharing its even neighbour's first
slot) and ``moe_combine`` (decode, both steps, bf16): the shapes of
``chip_smoke.py`` phase 3; and ``moe_combine`` after ``expert_ffn`` at
qwen3's decode and both steps, reading the buffer the FFN has just
written.  For each it prints the time of back-to-back
wrapper calls (CUDA events, as phase 3 times them: the wrapper's host work
included), the host time per call (wall clock over the same back-to-back
calls, nothing synchronised inside the loop), and the device time per call
and per launch of every kernel the call launches (``torch.profiler``:
kernel durations only).  Where the event time exceeds the device time, the
host, not the card, sets it.  ``rmsnorm`` and ``moe_dispatch`` get the
same split for their one-call yardsticks, ``F.rms_norm`` and
``torch.index_add``, and a split of their wrappers' host time at decode
into its parts; the two expert FFNs get it for their plain versions
(einsums on cuBLAS).  Random inputs from a seed; needs a card.
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from repro_torch.launch.common import device_profile, resolve_device


def _event_ms(fn, iters):
    for _ in range(3):
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


def _host_us(fn, iters):
    """Host wall time per call of ``iters`` back-to-back calls, with no
    synchronisation inside the loop (µs)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def _grouped_case(arch, S, infer, dev, g):
    from repro_torch.configs import get_config
    from repro_torch.core.gating import topk_gate
    from repro_torch.core.moe import shard_pool_capacity
    from repro_torch.kernels.expert_ffn_grouped import expert_ffn_grouped
    mcfg = get_config(arch).moe
    E, M, F = mcfg.n_experts, mcfg.d_model, mcfg.d_ff
    _, cap = shard_pool_capacity(S, 1, 1, mcfg.gate_config(), infer=infer)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev).mul_(scale)

    w1 = randn(E, M, F, scale=M ** -0.5)
    w3 = randn(E, M, F, scale=M ** -0.5) if mcfg.glu else None
    w2 = randn(E, F, M, scale=F ** -0.5)
    x = randn(S, M)
    r = topk_gate(x, randn(M, E, scale=M ** -0.5), mcfg.gate_config(), cap)
    flat, w = r.flat(cap, E), r.weights
    return (f"expert_ffn_grouped {arch} S={S} cap={cap}",
            lambda: expert_ffn_grouped(x, flat, w, w1, w3, w2, cap=cap,
                                       act=mcfg.act))


def _ffn_case(arch, S, infer, n_chunks, dev, g):
    """expert_ffn on ``arch``'s capacity buffer for ``S`` tokens, cut into
    ``n_chunks`` (s1d decode: qwen3, 8 tokens; gpt2-moe's s1 step: 8192
    tokens, 2 chunks), with the plain version beside it."""
    from repro_torch.configs import get_config
    from repro_torch.core.moe import shard_pool_capacity
    from repro_torch.kernels.expert_ffn import expert_ffn
    from repro_torch.kernels.ref import expert_ffn_ref
    mcfg = get_config(arch).moe
    E, M, F = mcfg.n_experts, mcfg.d_model, mcfg.d_ff
    _, cap = shard_pool_capacity(S, 1, 1, mcfg.gate_config(), infer=infer)
    T = cap // n_chunks
    x = torch.randn((E, T, M), generator=g, device=dev)
    w1 = torch.randn((E, M, F), generator=g, device=dev).mul_(M ** -0.5)
    w3 = torch.randn((E, M, F), generator=g, device=dev).mul_(
        M ** -0.5) if mcfg.glu else None
    w2 = torch.randn((E, F, M), generator=g, device=dev).mul_(F ** -0.5)
    act = mcfg.act
    return (f"expert_ffn {arch} E={E} T={T} M={M} F={F}",
            lambda: expert_ffn(x, w1, w3, w2, act=act),
            ("plain expert_ffn_ref",
             lambda: expert_ffn_ref(x, w1, w3, w2, act=act)))


def _ragged_case(dev, g):
    """expert_ffn_ragged at qwen3's s1g + fp8 step (E 128, one group, cap
    160, a random gate's counts), with the plain version beside it."""
    from repro_torch.kernels.expert_ffn_grouped import expert_ffn_ragged
    from repro_torch.kernels.ref import expert_ffn_ragged_ref
    q3 = "qwen3-moe-30b-a3b"
    x, flat, _, n = _gate(q3, 2048, False, dev, g)
    E, M = 128, x.shape[1]
    cap, F = n // E, 768
    counts = torch.bincount(flat.reshape(-1).long(), minlength=n + 1)[:n]
    counts = counts.reshape(E, cap).sum(dim=1, dtype=torch.int32)[:, None]
    w1, w3 = (torch.randn((E, M, F), generator=g, device=dev).mul_(M ** -0.5)
              for _ in range(2))
    w2 = torch.randn((E, F, M), generator=g, device=dev).mul_(F ** -0.5)
    xb = torch.randn((E, 1, cap, M), generator=g, device=dev)
    return (f"expert_ffn_ragged {q3} E={E} c={cap} routed "
            f"{int(counts.sum())}",
            lambda: expert_ffn_ragged(xb, counts.contiguous(), w1, w3, w2),
            ("plain expert_ffn_ragged_ref",
             lambda: expert_ffn_ragged_ref(xb, counts, w1, w3, w2)))


def _flash_case(B, L, H, K, hd, dev, g):
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn((B, L, H, hd), generator=g, device=dev)
    k = torch.randn((B, L, K, hd), generator=g, device=dev)
    v = torch.randn((B, L, K, hd), generator=g, device=dev)
    return (f"flash_attention B={B} L={L} H={H}/{K} hd={hd}",
            lambda: flash_attention(q, k, v, causal=True))


def _rmsnorm_case(R, dtype, dev, g):
    from repro_torch.kernels.rmsnorm import rmsnorm
    D = 2048
    x = torch.randn((R, D), generator=g, device=dev).to(dtype)
    scale = 1.0 + 0.1 * torch.randn((D,), generator=g, device=dev)
    w = scale.to(dtype)
    return (f"rmsnorm ({R}, {D}) {dtype}",
            lambda: rmsnorm(x, scale, eps=1e-6),
            ("F.rms_norm", lambda: F.rms_norm(x, (D,), weight=w, eps=1e-6)))


def _gate(arch, S, infer, dev, g):
    """(x, flat slots, gate weights, n_slots) of ``S`` random tokens of
    ``arch`` at the capacity its path uses."""
    from repro_torch.configs import get_config
    from repro_torch.core.gating import topk_gate
    from repro_torch.core.moe import shard_pool_capacity
    mcfg = get_config(arch).moe
    E, M = mcfg.n_experts, mcfg.d_model
    _, cap = shard_pool_capacity(S, 1, 1, mcfg.gate_config(), infer=infer)
    x = torch.randn((S, M), generator=g, device=dev)
    wg = torch.randn((M, E), generator=g, device=dev).mul_(M ** -0.5)
    r = topk_gate(x, wg, mcfg.gate_config(), cap)
    return x, r.flat(cap, E), r.weights, E * cap


def _dispatch_case(arch, S, infer, dtype, dup, dev, g):
    from repro_torch.kernels.moe_dispatch import moe_dispatch
    x, flat, _, n = _gate(arch, S, infer, dev, g)
    if dup:
        flat = flat.clone()
        flat[1::2, 0] = flat[0::2, 0]
    x = x.to(dtype)
    k, M = flat.shape[1], x.shape[1]
    src = x[:, None].expand(S, k, M).reshape(S * k, M)
    idx = flat.reshape(-1).long()
    zeros = torch.zeros((n + 1, M), dtype=dtype, device=dev)
    return (f"moe_dispatch {arch} S={S} k={k} M={M} n_slots={n} {dtype}"
            + (" duplicates" if dup else ""),
            lambda: moe_dispatch(x, flat, n),
            ("torch.index_add", lambda: torch.index_add(zeros, 0, idx, src)))


def _combine_case(arch, S, infer, dtype, dev, g):
    from repro_torch.kernels.moe_dispatch import moe_combine
    x, flat, w, n = _gate(arch, S, infer, dev, g)
    buf = torch.randn((n, x.shape[1]), generator=g, device=dev).to(dtype)
    return (f"moe_combine {arch} S={S} n_slots={n} {dtype}",
            lambda: moe_combine(buf, flat, w), None)


def _combine_after_ffn_case(arch, S, infer, dev, g):
    """moe_combine on the buffer ``expert_ffn`` has just written, as the
    s1 path runs them: the combine's per-launch device time on the path's
    traffic (buffer rows that fit stay in L2 from the FFN's stores)."""
    from repro_torch.kernels.moe_dispatch import moe_combine
    _, flat, w, n = _gate(arch, S, infer, dev, g)
    label, ffn, _ = _ffn_case(arch, S, infer, 1, dev, g)
    return (f"moe_combine after {label}, n_slots={n}",
            lambda: moe_combine(ffn().reshape(n, -1), flat, w), None)


def _report(label, fn, iters):
    """Print event, host and device time of ``fn`` and of its kernels."""
    ev = _event_ms(fn, iters)
    host = _host_us(fn, iters)
    prof = device_profile(lambda: [fn() for _ in range(iters)],
                          ev * iters, top=8)
    print(f"{label}: event {ev:.4f} ms per call; host {host:.1f} us per "
          f"call; device {prof['busy_ms'] / iters:.4f} ms per call ({iters} "
          f"calls traced)")
    for row in prof["top"]:
        print(f"    {row['ms'] / row['calls']:8.4f} ms per launch  "
              f"x{row['calls']}  {row['name'][:100]}")


def _host_parts(dev, g, iters):
    """Host time per call of the parts of the rmsnorm and moe_dispatch
    wrappers at decode's shapes: the whole call, its allocation, the stream
    read, the pointer reads, packing the C call's arguments, and the C call
    (ctypes and the launch; and ctypes alone, a call that launches
    nothing).  The rest of the wrapper is its checks."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import rmsnorm as rn
    x = torch.randn((8, 2048), generator=g, device=dev)
    scale = torch.rand((2048,), generator=g, device=dev) + 0.5
    out = torch.empty_like(x)
    card = x.get_device()
    stream = _build.stream_ptr(card)
    norm = (x.data_ptr(), scale.data_ptr(), out.data_ptr(), stream, 8, 2048,
            0, 1e-6)
    norm_packed, norm_none = rn._ARGS(*norm), rn._ARGS(*norm[:4], 0,
                                                         *norm[5:])
    xd, flat, _, n = _gate("qwen3-moe-30b-a3b", 8, True, dev, g)
    buf = torch.empty((n, 2048), device=dev)
    disp = (xd.data_ptr(), flat.data_ptr(), buf.data_ptr(), stream, 0, 8, 8,
            2048, n)
    disp_packed = md._DISPATCH_ARGS(*disp)
    disp_none = md._DISPATCH_ARGS(*disp[:8], 0)
    norm_fn, disp_fn = rn._c_fns()[0], md._c_fns()[0]
    parts = (
        ("rmsnorm: whole call", lambda: rn.rmsnorm(x, scale, eps=1e-6)),
        ("  torch.empty_like(x)", lambda: torch.empty_like(x)),
        ("  _build.stream_ptr", lambda: _build.stream_ptr(card)),
        ("  3 data_ptr()", lambda: (x.data_ptr(), scale.data_ptr(),
                                    out.data_ptr())),
        ("  pack the C call's arguments", lambda: rn._ARGS(*norm)),
        ("  C call (ctypes + launch)", lambda: norm_fn(norm_packed)),
        ("  C call of 0 rows (ctypes, no launch)",
         lambda: norm_fn(norm_none)),
        ("moe_dispatch: whole call", lambda: md.moe_dispatch(xd, flat, n)),
        ("  x.new_empty((n, M))", lambda: xd.new_empty((n, 2048))),
        ("  pack the C call's arguments",
         lambda: md._DISPATCH_ARGS(*disp)),
        ("  C call (ctypes + launch)", lambda: disp_fn(disp_packed)),
        ("  C call of 0 slots (ctypes, no launch)",
         lambda: disp_fn(disp_none)),
    )
    for label, fn in parts:
        print(f"host parts {label}: {_host_us(fn, iters):.2f} us per call")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default=None,
                    help="comma-separated kernels to time (default: all)")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    q3, g2 = "qwen3-moe-30b-a3b", "gpt2-moe"
    f32, bf16 = torch.float32, torch.bfloat16
    makers = {
        "expert_ffn_grouped": (
            lambda: _grouped_case(q3, 8, True, dev, g),
            lambda: _grouped_case(q3, 2048, False, dev, g),
            lambda: _grouped_case(g2, 8192, False, dev, g)),
        "expert_ffn": (
            lambda: _ffn_case(q3, 8, True, 1, dev, g),
            lambda: _ffn_case(g2, 8192, False, 2, dev, g)),
        "expert_ffn_ragged": (lambda: _ragged_case(dev, g),),
        "flash_attention": (
            lambda: _flash_case(1, 2048, 32, 4, 128, dev, g),
            lambda: _flash_case(8, 1024, 12, 12, 64, dev, g)),
        "rmsnorm": tuple(
            (lambda R=R, dt=dt: _rmsnorm_case(R, dt, dev, g))
            for R, dt in ((8, f32), (128, f32), (128, bf16), (2048, f32))),
        "moe_dispatch": tuple(
            (lambda a=a, S=S, inf=inf, dt=dt, dup=dup:
             _dispatch_case(a, S, inf, dt, dup, dev, g))
            for a, S, inf, dt, dup in (
                (q3, 8, True, f32, False), (q3, 2048, False, f32, False),
                (g2, 8192, False, f32, False), (g2, 8192, False, bf16, False),
                (g2, 8192, False, f32, True))),
        "moe_combine": tuple(
            (lambda a=a, S=S, inf=inf, dt=dt:
             _combine_case(a, S, inf, dt, dev, g))
            for a, S, inf, dt in (
                (q3, 8, True, f32), (q3, 2048, False, f32),
                (g2, 8192, False, f32), (g2, 8192, False, bf16))) + tuple(
            (lambda a=a, S=S, inf=inf:
             _combine_after_ffn_case(a, S, inf, dev, g))
            for a, S, inf in ((q3, 8, True), (q3, 2048, False),
                              (g2, 8192, False))),
    }
    chosen = args.kernels.split(",") if args.kernels else list(makers)
    unknown = sorted(set(chosen) - set(makers))
    if unknown:
        ap.error(f"unknown kernels {unknown} (have {sorted(makers)})")
    print(f"card: {torch.cuda.get_device_name(0)}")
    if {"rmsnorm", "moe_dispatch"} & set(chosen):
        _host_parts(dev, g, 200)
    for name in chosen:
        for make in makers[name]:
            label, fn, *yard = make()
            _report(label, fn, args.iters)
            if yard and yard[0] is not None:
                lib_name, lib_fn = yard[0]
                _report(f"  yardstick {lib_name}", lib_fn, args.iters)
            del fn, yard
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
