"""Which ops of a training step may sum in an undefined order on the card,
and whether the step repeats bit for bit.

    PYTHONPATH=src python -m repro_torch.launch.determinism [--layers 4]
        [--paths qwen3,qwen3_s1g_fp8,gpt2_moe,gpt2_moe_s1_pipe2]

For each training path of ``chip_smoke.py`` phases 7 and 8 (qwen3-moe-
30b-a3b at full width, 4 layers, 1 x 2048 tokens, under ``auto`` and under
``s1g`` with the fp8 wire; gpt2-moe at its full size, 8 x 1024, under
``auto`` and under ``s1`` with 2 chunks), it takes one step from seeded
parameters and prints:

* ``raises``: the ops that ``torch.use_deterministic_algorithms(True)``
  refuses (they have no deterministic version), gathered with
  ``warn_only=True`` so that one step lists them all.  ``main`` sets
  ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before CUDA starts, as the flag
  asks (importing the module sets nothing);
* ``swapped``: the ops the step runs, by ``torch.profiler`` with the flag
  off, that the flag replaces by a deterministic version
  (``DETERMINISTIC_SWAPS``: scatters and index adds that use atomics);
  each is deterministic anyway where no two terms land on one element;
* ``repeat``: whether the step taken twice from the same parameters,
  AdamW state and batch, flag off, gives ``torch.equal`` parameters,
  moments, step counter and loss (:func:`first_step_twice`).

Needs a card; the JSON lines go to standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import warnings
from dataclasses import replace

import torch

from repro_torch.optim.adamw import leaves

#: aten ops that ``use_deterministic_algorithms(True)`` swaps for a
#: deterministic version on CUDA (its docstring's list, by the aten names
#: the profiler records; the backward of ``gather`` and ``index_select``
#: runs ``scatter_add_`` and ``index_add_``)
DETERMINISTIC_SWAPS = (
    "aten::index_add_", "aten::index_add", "aten::index_put_",
    "aten::_index_put_impl_", "aten::put_", "aten::scatter_add_",
    "aten::scatter_add", "aten::scatter_", "aten::scatter",
    "aten::scatter_reduce_", "aten::scatter_reduce", "aten::index_copy_",
    "aten::index_copy", "aten::repeat_interleave")

PATHS = ("qwen3", "qwen3_s1g_fp8", "gpt2_moe", "gpt2_moe_s1_pipe2")


def path_setup(path, layers, dev):
    """(config, schedule, batch, seq, lr) of a phase-7/8 training path."""
    from repro_torch.configs import get_config
    from repro_torch.core.collectives import CommConfig
    if path.startswith("qwen3"):
        cfg = replace(get_config("qwen3-moe-30b-a3b"), n_layers=layers)
        if path == "qwen3_s1g_fp8":
            cfg = replace(cfg, moe=replace(
                cfg.moe, comm=CommConfig(wire_dtype="fp8_e4m3")))
            return cfg, "s1g", 1, 2048, 1e-4
        return cfg, None, 1, 2048, 1e-4
    cfg = get_config("gpt2-moe")
    if path == "gpt2_moe_s1_pipe2":
        return replace(cfg, moe=replace(cfg.moe, pipeline_chunks=2)), "s1", \
            8, 1024, 1e-3
    return cfg, None, 8, 1024, 1e-3


def _state(params, opt_state):
    return leaves(params) + leaves(opt_state["mu"]) + leaves(opt_state["nu"])


#: the bytes of each host block a taking's state waits in
#: (:func:`hold`): one size, so the caching host allocator rounds no
#: tensor up to a power of two and hands a later check the same blocks
HOST_BLOCK = 1 << 30


def hold(state, block_bytes=HOST_BLOCK, pin=False):
    """Copies of ``state``'s tensors packed into host blocks of
    ``block_bytes`` bytes, page-locked where ``pin`` (the card's copies
    then run at the link's rate; into fresh pageable memory they run at
    the rate the host faults pages in).  Per tensor, its shape and its
    ``(flat start, piece)`` pairs, each piece a view of a block in the
    tensor's dtype."""
    held, block, off = [], None, block_bytes
    for t in state:
        flat, es, pieces, pos = t.reshape(-1), t.element_size(), [], 0
        while pos < flat.numel():
            off = -(-off // 8) * 8
            if block_bytes - off < es:
                block, off = torch.empty(block_bytes, dtype=torch.uint8,
                                         pin_memory=pin), 0
            n = min(flat.numel() - pos, (block_bytes - off) // es)
            piece = block[off:off + n * es].view(t.dtype)
            piece.copy_(flat[pos:pos + n])
            pieces.append((pos, piece))
            pos, off = pos + n, off + n * es
        held.append((t.shape, pieces))
    return held


def same(held_t, t) -> bool:
    """Whether ``t`` is ``torch.equal`` to ``held_t`` (one tensor of
    :func:`hold`), a piece brought to ``t``'s device at a time."""
    shape, pieces = held_t
    flat = t.reshape(-1)
    return t.shape == shape and all(
        torch.equal(flat[p:p + piece.numel()], piece.to(t.device))
        for p, piece in pieces)


def release_host_blocks():
    """Give the caching host allocator's free page-locked blocks back to
    the system (where the build has one)."""
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None and torch.cuda.is_available():
        empty()


def first_steps(trainer, batch, steps, seed=0):
    """Take the first step once with each of ``steps`` (callables
    ``(params, opt_state, batch) -> (params, opt_state, metrics)``), each
    from ``trainer.setup`` of the same seed (the same parameters and zero
    AdamW state) on ``batch``.  Returns, for each taking after the first,
    the indices of the tensors that are not ``torch.equal`` to the first
    taking's, in ``leaves(params) + leaves(mu) + leaves(nu)`` order, then
    the step counter and the loss.  The first taking's state waits on the
    host (:func:`hold`, page-locked for a card; the blocks stay with the
    caching host allocator for the next check, until
    :func:`release_host_blocks`), so the card holds one state at a time;
    each later taking is compared with it on its own device, a piece of
    the first brought back at a time."""
    dev = trainer.model.device
    first, bad = None, []
    for step in steps:
        params, opt_state = trainer.setup(
            torch.Generator(device=dev).manual_seed(seed))
        params, opt_state, m = step(params, opt_state, batch)
        state = [t.detach() for t in _state(params, opt_state)] + [
            opt_state["step"], m["loss"]]
        if first is None:
            first = hold(state, pin=dev.type == "cuda")
        else:
            bad.append([i for i, (a, b) in enumerate(zip(first, state))
                        if not same(a, b)])
        del params, opt_state, state, m
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return bad


def first_step_twice(trainer, batch, seed=0):
    """:func:`first_steps` with the plain step taken twice: the indices
    of the tensors of the second taking that differ from the first's."""
    return first_steps(trainer, batch, [trainer.train_step] * 2, seed)[0]


def _profiled_ops(run):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return {e.key: e.count for e in prof.key_averages()
            if e.key in DETERMINISTIC_SWAPS}


def probe(path, layers, dev):
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer
    cfg, schedule, B, L, lr = path_setup(path, layers, dev)
    tr = Trainer(Model(cfg, device=dev), AdamWConfig(lr=lr, warmup_steps=2,
                                                     total_steps=5),
                 schedule=schedule)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=L,
                                   global_batch=B)).tensors(0, dev)

    def step():
        params, opt_state = tr.setup(
            torch.Generator(device=dev).manual_seed(0))
        tr.train_step(params, opt_state, batch)
        torch.cuda.synchronize()

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step()
        finally:
            torch.use_deterministic_algorithms(False)
    raises = sorted({str(w.message).split(" does not have")[0]
                     for w in caught if "deterministic" in str(w.message)})
    swapped = _profiled_ops(step)
    torch.cuda.empty_cache()
    bad = first_step_twice(tr, batch)
    return {"path": path, "schedule": schedule or cfg.moe.schedule,
            "raises": raises, "swapped": swapped,
            "repeat_bitwise": not bad, "leaves_differing": len(bad)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4,
                    help="qwen3's depth (gpt2-moe runs at its full 12)")
    ap.add_argument("--paths", default=",".join(PATHS))
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device: this probe runs on the card")
    from repro_torch.launch.common import resolve_device
    dev = resolve_device("cuda")
    for path in args.paths.split(","):
        print(json.dumps(probe(path, args.layers, dev)), flush=True)


if __name__ == "__main__":
    main()
