"""Quickstart: train a tiny MoE transformer with Parm's schedules.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu \\
        --nproc 8 --dist-backend gloo

Builds a reduced Qwen3-MoE, prints which schedule Algorithm 1 picks on the
run's mesh and the cost model that priced it (the card's ``h100_model``),
trains 60 steps on the synthetic corpus under ``schedule="auto"`` and
prints the loss trajectory.  ``--nproc N`` spawns N ranks on the mesh
``(data=max(1, N // 2), model=N / data)`` (EP over data, ESP == MP over
model), over ``--dist-backend`` (gloo: ranks sharing one card, or the
CPU; nccl: one card a rank).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.core.moe import select_schedule
from repro_torch.core.perfmodel import MoELayerShape
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.common import resolve_device
from repro_torch.launch.mesh import check_backend, spawn
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig
from repro_torch.parallel.mesh import Mesh, ParallelDims, make_mesh
from repro_torch.train import Trainer

DIMS = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
NAMES = ("data", "model")
#: the synthetic corpus's batch, and the layer shape Algorithm 1 prices
BATCH, SEQ = 8, 64


def mesh_shape(n: int) -> tuple:
    """The example's mesh over ``n`` ranks: ``(max(1, n // 2), n / that)``."""
    d = max(1, n // 2) if n > 1 else 1
    return d, max(n // d, 1)


def pick(cfg, sizes: dict, perf_model=None) -> str:
    """Algorithm 1's pick for ``cfg``'s MoE layer over ``BATCH x SEQ``
    tokens on a mesh of ``sizes`` (``ep``, ``esp``, ``mp``), priced by
    ``perf_model`` (default: the card's ``h100_model`` of those sizes)."""
    m = cfg.moe
    shape = MoELayerShape(
        B=BATCH, L=SEQ, M=cfg.d_model, H=m.d_ff, E=m.n_experts, k=m.top_k,
        f=m.capacity_factor, n_mp=sizes["mp"], n_esp=sizes["esp"],
        n_ep=sizes["ep"])
    return select_schedule(m, shape, perf_model=perf_model)


def run(args, dev, mesh=None):
    """The example on one rank (``mesh=None``) or as this rank of
    ``mesh``; returns the loss history."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    shown = mesh if mesh is not None else Mesh((1, 1), NAMES)
    sizes = DIMS.sizes(shown)
    print(f"mesh {shown.shape} -> Algorithm 1 picks: {pick(cfg, sizes)} "
          f"(cost model h100_model(n_ep={sizes['ep']}, n_esp="
          f"{sizes['esp']}, n_mp={sizes['mp']}))", flush=True)
    model = Model(cfg, device=dev)
    tr = Trainer(model, AdamWConfig(lr=2e-3, warmup_steps=5,
                                    total_steps=args.steps),
                 schedule="auto", mesh=mesh,
                 dims=DIMS if mesh is not None else None)
    params, opt = tr.setup(torch.Generator(device=dev).manual_seed(0))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=BATCH, n_heavy=4,
                                  heavy_prob=0.9))
    params, opt, hist = tr.run(params, opt, data, args.steps,
                               log_every=max(args.steps // 4, 1))
    print(f"done: loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}",
          flush=True)
    return hist


def _rank(rank, args):
    """One rank of ``--nproc``: the mesh, then the run; rank 0 prints."""
    shape = mesh_shape(args.nproc)
    mesh = make_mesh(shape, NAMES)
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    dev = (torch.device("cpu") if args.device == "cpu" else
           torch.device("cuda", torch.cuda.current_device()))
    return run(args, dev, mesh)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend, required with "
                         "--nproc > 1")
    args = ap.parse_args(argv)
    if args.steps < 1 or args.nproc < 1:
        ap.error("--steps and --nproc must be >= 1")
    dev = resolve_device(args.device)
    if args.nproc == 1:
        return run(args, dev)
    if args.dist_backend is None:
        ap.error("more than one rank needs --dist-backend nccl|gloo")
    try:
        check_backend(args.dist_backend, args.nproc, dev.type)
    except (ValueError, RuntimeError) as e:
        ap.error(str(e))
    return spawn(_rank, args.nproc, args, backend=args.dist_backend,
                 device=dev.type, threads=1 if dev.type == "cpu" else None)[0]


if __name__ == "__main__":
    main()
