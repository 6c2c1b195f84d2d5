"""End-to-end example: train a ~100M-parameter MoE language model for a few
hundred steps on the synthetic corpus.

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_100m --device cpu \\
        --steps 3 --seq 32 --batch 2

The config is a scaled GPT-2-MoE (the JAX example's): 8 layers, d_model
512, 8 heads, d_ff 2048, the GPT-2 vocabulary, 8 experts top-2 at capacity
factor 1.5 (non-GLU), no remat, under Parm's auto-scheduling on one rank.
Prints the parameter count and the cross-entropy first -> last, and
asserts that it fell.
"""

from __future__ import annotations

import argparse
from dataclasses import replace

import torch

from repro_torch.configs import get_config
from repro_torch.core.moe import MoEConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.common import resolve_device
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import leaves
from repro_torch.train import Trainer


def config_100m():
    base = get_config("gpt2-moe")
    moe = MoEConfig(d_model=512, d_ff=2048, n_experts=8, top_k=2,
                    capacity_factor=1.5, glu=False, schedule="auto")
    return replace(base, name="gpt2-moe-100m", n_layers=8, d_model=512,
                   n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=50257,
                   moe=moe, remat=False)


def train(dev, steps: int, seq: int = 256, batch: int = 8):
    """``steps`` AdamW steps of :func:`config_100m` on ``dev``; returns the
    history (raises ``AssertionError`` unless the cross-entropy fell)."""
    cfg = config_100m()
    model = Model(cfg, device=dev)
    tr = Trainer(model, AdamWConfig(lr=6e-4, warmup_steps=20,
                                    total_steps=steps))
    params, opt = tr.setup(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in leaves(params))
    print(f"model: {cfg.name}  params: {n_params / 1e6:.1f}M  "
          f"device: {dev}", flush=True)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, n_heavy=8,
                                  heavy_prob=0.85))
    params, opt, hist = tr.run(params, opt, data, steps,
                               log_every=max(steps // 15, 1))
    print(f"CE: {hist[0]['ce']:.3f} -> {hist[-1]['ce']:.3f} over {steps} "
          f"steps ({hist[-1]['wall_s']:.0f}s)", flush=True)
    if not hist[-1]["ce"] < hist[0]["ce"]:
        raise AssertionError("training must make progress")
    return hist


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return train(resolve_device(args.device), args.steps, args.seq,
                 args.batch)


if __name__ == "__main__":
    main()
