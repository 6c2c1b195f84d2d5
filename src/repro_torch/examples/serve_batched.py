"""Batched serving example: greedy decode with a KV cache, the MoE decode
path and the recurrent archs' O(1)-state decode.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu

Four reduced archs (qwen1.5-0.5b, qwen3-moe-30b-a3b, xlstm-350m,
hymba-1.5b), random weights from a seed, each decoding a batch of 4 rows
for 24 tokens from a zero token through ``Model.init_cache`` and
``train.make_serve_step``; prints tok/s and row 0's first tokens.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch.common import resolve_device
from repro_torch.models import Model
from repro_torch.train import make_serve_step

ARCHS = ("qwen1.5-0.5b", "qwen3-moe-30b-a3b", "xlstm-350m", "hymba-1.5b")


def serve(name: str, dev, gen: int = 24, batch: int = 4,
          params=None) -> list:
    """Greedy decode of reduced ``name`` on ``dev``: ``gen`` steps of
    ``batch`` rows from a zero token, with ``params`` (default: the
    model's from seed 0).  Prints tok/s and row 0's first 8 tokens;
    returns every step's tokens, ``gen`` lists of ``batch``."""
    model = Model(get_config(name).reduced(), device=dev)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    cache = model.init_cache(batch, gen + 1)
    step = make_serve_step(model)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    toks = []
    for t in range(gen):
        tok, cache = step(params, cache, {"tokens": tok, "step": t})
        toks.append(tok[:, 0].tolist())
    dt = time.perf_counter() - t0
    print(f"{name:24s} {batch * gen / dt:7.1f} tok/s   first tokens: "
          f"{[row[0] for row in toks[:8]]}", flush=True)
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return {name: serve(name, dev) for name in ARCHS}


if __name__ == "__main__":
    main()
