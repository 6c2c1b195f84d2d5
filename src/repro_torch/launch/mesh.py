"""Process groups and the launcher's mesh (counterpart of
``repro/launch/mesh.py`` and the ``(data, model)`` layout of
``repro/launch/train.py``).

``init_distributed`` starts ``torch.distributed`` for one rank: from
``torchrun``'s environment when it is present, otherwise from the
caller's ``world`` and ``rank`` (the launcher spawns its ranks itself)
with a ``FileStore`` rendezvous in a directory the caller names, never a
fixed TCP port, so runs in parallel do not collide.  Rank ``r`` runs on
``cuda:(r % device_count)``.

The backend is always the caller's choice.  ``nccl`` needs one card per
rank and refuses to start more ranks than cards (NCCL itself rejects two
ranks on one card, "Duplicate GPU detected"); ``gloo`` runs any number of
ranks, on CPU tensors or sharing one card's tensors (its collectives
stage CUDA tensors through the host, so it times the host, not a link).
Nothing picks gloo silently.

``make_production_mesh`` / ``make_test_mesh`` are JAX's meshes (16x16 or
2x16x16; 4x2 or 2x2x2) with its axis names, as port meshes; the dry run
traces one of their ranks under ``fake_world``, the fake backend that
only it starts.
"""

from __future__ import annotations

import os

import torch

from repro_torch.parallel.mesh import ParallelDims, production_dims

BACKENDS = ("nccl", "gloo")

#: JAX's meshes (``repro/launch/mesh.py``): multi_pod -> (shape, axes)
PRODUCTION_SHAPE = {False: ((16, 16), ("data", "model")),
                    True: ((2, 16, 16), ("pod", "data", "model"))}
TEST_SHAPE = {False: ((4, 2), ("data", "model")),
              True: ((2, 2, 2), ("pod", "data", "model"))}


def _named_mesh(shape, names):
    """The port :class:`~repro_torch.parallel.mesh.Mesh` of ``shape``: over
    the initialised default group (its process groups made) when its
    world is the mesh's size, else for layout arithmetic at rank 0."""
    import torch.distributed as dist

    from repro_torch.parallel.mesh import Mesh, make_mesh
    n = 1
    for s in shape:
        n *= s
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == n:
        return make_mesh(shape, names)
    return Mesh(shape, names, 0)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks), JAX's
    axis names; see :func:`_named_mesh` for the ranks."""
    return _named_mesh(*PRODUCTION_SHAPE[multi_pod])


def make_test_mesh(*, multi_pod: bool = False):
    """The scaled-down mesh with the same axis names (8 ranks: 4x2, or
    2x2x2 multi-pod)."""
    return _named_mesh(*TEST_SHAPE[multi_pod])


def fake_world(world: int, rank: int = 0) -> None:
    """Start ``torch.distributed`` on its ``fake`` backend as ``rank`` of
    ``world``: every collective returns at once and moves nothing (a
    receive keeps what its buffer held), so one process can trace one
    rank of a production mesh on the meta device.  Only the dry run
    (``launch/dryrun.py``) starts it; :data:`BACKENDS` never offers it."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch.distributed's fake backend "
            "(torch.testing._internal.distributed.fake_pg), which this "
            f"torch {torch.__version__} lacks") from e
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def dims_for(cfg, multi_pod: bool = False) -> ParallelDims:
    """Logical parallel dims for an architecture on the ``(data, model)``
    mesh: EP over ``data``, ESP == MP over ``model`` for MoE archs."""
    return production_dims(multi_pod=multi_pod, moe=cfg.moe is not None)


def parse_mesh(spec: str, n: int):
    """``--mesh data=D,model=M`` -> ``(shape, names)``; D x M must be n.
    The launcher's default is ``data=n,model=1``: every rank a data (=
    EP) rank.  (The JAX launcher folds its devices into ``(n // 2, 2)``;
    the port takes the split from ``--mesh``.)"""
    names, shape = [], []
    for part in spec.split(","):
        name, _, size = part.partition("=")
        if not size:
            raise ValueError(f"--mesh entry {part!r}: want name=size")
        names.append(name.strip())
        shape.append(int(size))
    total = 1
    for s in shape:
        total *= s
    if total != n:
        raise ValueError(f"--mesh {spec}: {total} ranks, --nproc {n}")
    return tuple(shape), tuple(names)


def device_for(rank: int, device: str = "cuda") -> torch.device:
    """Rank ``r``'s device: ``cuda:(r % device_count)``, or the CPU."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def torchrun_env() -> bool:
    """True when ``torchrun`` (or another launcher) set the rank's env."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))


def check_backend(backend: str, world: int, device: str = "cuda") -> None:
    """Raise unless ``backend`` can run ``world`` ranks on ``device``:
    ``nccl`` needs a CUDA card a rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}, want one of {BACKENDS}")
    if backend == "nccl":
        if device == "cpu":
            raise ValueError("nccl runs on CUDA cards; --device cpu needs "
                             "--dist-backend gloo")
        n_cards = torch.cuda.device_count()
        if world > n_cards:
            raise RuntimeError(
                f"nccl: {world} ranks on {n_cards} card(s): NCCL needs one "
                "card per rank (two ranks on one card fail with 'Duplicate "
                "GPU detected'); name --dist-backend gloo to share a card")


def init_distributed(backend: str, world: int | None = None,
                     rank: int | None = None, *, store_dir: str | None = None,
                     device: str = "cuda"):
    """Start ``torch.distributed`` for this rank and return ``(rank,
    world, device)``.  With ``torchrun``'s environment the rank and world
    come from it; otherwise ``world``, ``rank`` and ``store_dir`` (a
    directory all ranks share; the store file is made in it) are
    required.  ``nccl`` with more ranks than cards raises."""
    import torch.distributed as dist
    if torchrun_env():
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init = "env://"
    else:
        if world is None or rank is None or store_dir is None:
            raise ValueError("init_distributed without torchrun's "
                             "environment needs world, rank and store_dir")
        init = f"file://{os.path.join(store_dir, 'rendezvous')}"
    check_backend(backend, world, device)
    dev = device_for(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, **kw)
    return rank, world, dev



def _rank_main(rank, fn, world, store_dir, backend, device, threads, args):
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    init_distributed(backend, world, rank, store_dir=store_dir,
                     device=device)
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(store_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, *args, backend: str, device: str = "cuda",
          threads: int | None = None, timeout: float = 900.0):
    """Run ``fn(rank, *args)`` on ``nprocs`` new processes (``spawn``,
    never ``fork``), each with ``torch.distributed`` started on
    ``backend``; returns each rank's return value (moved through
    ``torch.save``), in rank order.  A rank that fails fails the call
    (``torch.multiprocessing.ProcessRaisedException`` or
    ``ProcessExitedException``) and the other ranks are terminated; so
    are all of them when ``timeout`` seconds pass (``TimeoutError``).
    ``threads`` sets each rank's ``torch.set_num_threads``."""
    import tempfile
    import time

    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as d:
        ctx = mp.start_processes(_rank_main, args=(fn, nprocs, d, backend,
                                                   device, threads, args),
                                 nprocs=nprocs, start_method="spawn",
                                 join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"{nprocs} ranks of {fn.__name__} ran "
                                   f"past {timeout:.0f} s")
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
