"""Device time of the port's redesigned kernels at the main paths' shapes.

    PYTHONPATH=src python -m repro_torch.launch.kernel_times [--iters 20]

For ``expert_ffn_grouped`` (qwen3-moe-30b-a3b decode, 8 tokens; the qwen3
and gpt2-moe training steps, every slot filled) and ``flash_attention``
(both training shapes), prints the time of back-to-back wrapper calls
(CUDA events, as ``chip_smoke.py`` phase 3 times them: the wrapper's host
work included) beside the device time per call and per launch of every
kernel the call launches (``torch.profiler``: kernel durations only).
Where the two differ, the host, not the card, sets the event time.
Random inputs from a seed; needs a card.
"""

from __future__ import annotations

import argparse

import torch

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


def _flash_case(B, L, H, K, hd, dev, g):
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn((B, L, H, hd), generator=g, device=dev)
    k = torch.randn((B, L, K, hd), generator=g, device=dev)
    v = torch.randn((B, L, K, hd), generator=g, device=dev)
    return (f"flash_attention B={B} L={L} H={H}/{K} hd={hd}",
            lambda: flash_attention(q, k, v, causal=True))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    makers = (lambda: _grouped_case("qwen3-moe-30b-a3b", 8, True, dev, g),
              lambda: _grouped_case("qwen3-moe-30b-a3b", 2048, False, dev,
                                    g),
              lambda: _grouped_case("gpt2-moe", 8192, False, dev, g),
              lambda: _flash_case(1, 2048, 32, 4, 128, dev, g),
              lambda: _flash_case(8, 1024, 12, 12, 64, dev, g))
    print(f"card: {torch.cuda.get_device_name(0)}")
    for make in makers:
        label, fn = make()
        ev = _event_ms(fn, args.iters)
        prof = device_profile(lambda: [fn() for _ in range(args.iters)],
                              ev * args.iters, top=8)
        # calls as the profiler saw them: its heaviest kernel launches once
        # per call
        n = prof["top"][0]["calls"]
        print(f"{label}: event {ev:.4f} ms per call; device "
              f"{prof['busy_ms'] / n:.4f} ms per call ({n} calls traced)")
        for row in prof["top"]:
            print(f"    {row['ms'] / row['calls']:8.4f} ms per launch  "
                  f"x{row['calls']}  {row['name'][:100]}")
        del fn
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
