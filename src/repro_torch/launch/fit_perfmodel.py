"""Fit the cost model's compute rate and collective startup on the card
(the port's counterpart of ``benchmarks/bench_fig6_perfmodel.py``'s
measure-and-fit, narrowed to what one card can measure).

  PYTHONPATH=src python -m repro_torch.launch.fit_perfmodel

Two least-squares fits (``perfmodel.fit_alpha_beta``), each printed with
its R^2 (the paper's own check asserts R^2 > 0.8):

  * ``flops_per_s`` is 1/beta of the port's ``expert_ffn`` time against
    the kernel's real flop count, ``6 * E * T * M * F`` (three GEMMs of a
    GLU expert, a multiply-add counted as two), at qwen3-moe-30b-a3b's
    expert shape (E 128, M 2048, F 768) and the capacities ``CAPACITIES``;
  * ``alpha`` is the intercept of the one-rank collective stage's time
    against its size: ``collectives.wire_roundtrip`` on the bf16 wire (an
    f32 stage is the identity) at ``SIZES`` elements, the sizes of the
    reference's Fig. 6 fit.

Each time is the median of ``iters`` runs, each bracketed by a pair of
CUDA events on the current stream with a 256 MB fill enqueued just
before: the card is busy while the host enqueues the run, so the events
bracket device time and not the host's launch latency, and the fill
leaves the L2 cache cold, as a real stage finds it.

The link betas of groups larger than one cannot be measured on one card:
they stay ``h100_model``'s data-sheet figures (NVLink 4, NDR InfiniBand)
until the multi-rank slice fits them over NCCL.  With no card the fit
raises; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
from dataclasses import fields, replace

import torch

from repro_torch.core.perfmodel import (ALPHA_COLL, AlphaBeta, PerfModel,
                                        fit_alpha_beta, h100_model)

#: one-rank wire stage sizes, elements (the reference's Fig. 6 sizes)
SIZES = [2 ** i for i in range(12, 21)]
#: expert capacities (rows per expert) of the compute fit
CAPACITIES = (32, 64, 128, 256)
#: qwen3-moe-30b-a3b's GLU experts
E, M, F = 128, 2048, 768


def r_squared(sizes, times, fit) -> float:
    """Coefficient of determination of ``fit`` over the samples."""
    mean = sum(times) / len(times)
    ss_tot = sum((t - mean) ** 2 for t in times)
    ss_res = sum((t - fit(x)) ** 2 for x, t in zip(sizes, times))
    return 1 - ss_res / ss_tot if ss_tot else 1.0


def _device_s(fn, dev, pad, iters: int = 20, warmup: int = 3) -> float:
    """Median device seconds of ``fn()`` (see the module docstring)."""
    for _ in range(warmup):
        fn()
    stream = torch.cuda.current_stream(dev)
    pairs = []
    for _ in range(iters):
        pad.fill_(0.0)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record(stream)
        fn()
        t1.record(stream)
        pairs.append((t0, t1))
    torch.cuda.synchronize(dev)
    ts = sorted(t0.elapsed_time(t1) * 1e-3 for t0, t1 in pairs)
    return ts[len(ts) // 2]


def _fit(sizes, times) -> dict:
    ab = fit_alpha_beta(sizes, times)
    return {"sizes": list(sizes), "times": list(times), "fit": ab,
            "r2": r_squared(sizes, times, ab)}


def measure_card(device="cuda") -> dict:
    """Time both fits' samples on the card and fit them.  Returns
    ``{"flops": fit, "alpha": fit}``, each fit a dict of ``sizes``,
    ``times`` (seconds), ``fit`` (an ``AlphaBeta``) and ``r2``."""
    from repro_torch.core.collectives import CommConfig, wire_roundtrip
    from repro_torch.kernels.expert_ffn import expert_ffn

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"fit_perfmodel measures the card; {dev} is "
                           f"not a CUDA device (or none is available)")
    gen = torch.Generator(device=dev).manual_seed(0)
    pad = torch.empty(64 * 2 ** 20, device=dev)        # 256 MB
    with torch.no_grad():
        w1 = torch.randn((E, M, F), generator=gen, device=dev) * M ** -0.5
        w3 = torch.randn((E, M, F), generator=gen, device=dev) * M ** -0.5
        w2 = torch.randn((E, F, M), generator=gen, device=dev) * F ** -0.5
        flops, t_ffn = [], []
        for T in CAPACITIES:
            x = torch.randn((E, T, M), generator=gen, device=dev)
            flops.append(6.0 * E * T * M * F)
            t_ffn.append(_device_s(lambda: expert_ffn(x, w1, w3, w2), dev,
                                   pad, iters=10, warmup=2))
        del w1, w3, w2, x
        comm = CommConfig(wire_dtype="bf16")
        t_coll = []
        for n in SIZES:
            x = torch.randn((64, n // 64), generator=gen, device=dev)
            t_coll.append(_device_s(lambda: wire_roundtrip(x, comm), dev,
                                    pad))
    return {"flops": _fit(flops, t_ffn), "alpha": _fit(SIZES, t_coll)}


def model_from_fits(fits: dict, n_ep: int = 1, n_esp: int = 1,
                    n_mp: int = 1) -> PerfModel:
    """``h100_model`` with the fitted compute rate and startup: every
    collective's alpha is rescaled from ``ALPHA_COLL`` to the fitted one
    (its per-member multiple kept), the link betas stay the data
    sheet's."""
    pm = h100_model(n_ep, n_esp, n_mp)
    ratio = fits["alpha"]["fit"].alpha / ALPHA_COLL
    scaled = {f.name: replace(ab, alpha=ab.alpha * ratio)
              for f in fields(pm)
              if isinstance(ab := getattr(pm, f.name), AlphaBeta)}
    return replace(pm, flops_per_s=1.0 / fits["flops"]["fit"].beta, **scaled)


def fit_card_model(device="cuda", n_ep: int = 1, n_esp: int = 1,
                   n_mp: int = 1) -> PerfModel:
    """An ``h100_model`` whose ``flops_per_s`` and alphas are fitted on
    the card (:func:`measure_card`, :func:`model_from_fits`)."""
    return model_from_fits(measure_card(device), n_ep, n_esp, n_mp)


def report(fits: dict, model: PerfModel) -> list:
    """Printable lines: each fit's samples, values and R^2, beside the
    data-sheet model's figures."""
    sheet = h100_model(1, 1, 1)
    ff, fa = fits["flops"], fits["alpha"]
    return [
        "expert_ffn (E 128, M 2048, F 768, T "
        + "/".join(str(t) for t in CAPACITIES) + "): ms "
        + " ".join(f"{t * 1e3:.4f}" for t in ff["times"])
        + f"; fit alpha {ff['fit'].alpha * 1e6:.2f} us, "
        f"rate {model.flops_per_s / 1e12:.2f} TFLOP/s (data sheet "
        f"{sheet.flops_per_s / 1e12:.0f}), R^2 {ff['r2']:.5f}",
        "wire_roundtrip bf16 (2^12..2^20 elements): us "
        + " ".join(f"{t * 1e6:.2f}" for t in fa["times"])
        + f"; fit alpha {fa['fit'].alpha * 1e6:.3f} us (model constant "
        f"{ALPHA_COLL * 1e6:.3f}), beta {fa['fit'].beta * 1e12:.4f} ps/el, "
        f"R^2 {fa['r2']:.5f}"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from repro_torch.launch.common import resolve_device
    dev = resolve_device(args.device)
    fits = measure_card(dev)
    for line in report(fits, model_from_fits(fits)):
        print(line)
    print(f"device: {torch.cuda.get_device_name(dev)}")


if __name__ == "__main__":
    main()
