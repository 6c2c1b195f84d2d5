"""The process mesh and the logical parallel dims (counterpart of
``repro/parallel/mesh.py``).

Parm's schedules are expressed over four *logical* parallel dimensions --
DP (pure data parallel), EP (expert parallel), ESP (expert-sharding
parallel) and MP (model parallel) -- each mapped onto one or more physical
mesh axes.  ``ParallelDims``, ``axis_size`` and ``production_dims`` are
the JAX module's, copied; they read a mesh's ``shape`` (axis name ->
size) as they read a ``jax.sharding.Mesh``'s.

The port's :class:`Mesh` stands where JAX's device mesh stands: the ranks
of the default ``torch.distributed`` group laid out row-major over named
axes, this rank's coordinates, and one ``ProcessGroup`` for every subset
of the axes.  ``dist.new_group`` is collective, so every rank creates
every group at construction, in one fixed order.

Rank order in a group: ``dist.new_group`` sorts its ranks, so a group's
ranks run in global-rank order, which is row-major in the *mesh's* axis
order.  JAX's ``axis_index`` over an axis tuple, and the chunk order of
``lax.all_to_all`` / ``lax.all_gather`` over it, are row-major in the
*tuple's* order.  :meth:`Mesh.group` therefore returns an
:class:`AxisGroup` that carries, beside the process group, the JAX index
of the member at each group position; the collectives
(``repro_torch.parallel.comm``) permute their chunks by it, so a tuple
whose order differs from the mesh's moves data as JAX moves it.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass


def axis_size(mesh, axes) -> int:
    """Product of sizes of ``axes`` (a name or tuple of names) in ``mesh``."""
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes) if axes else 1


@dataclass(frozen=True)
class ParallelDims:
    """Mapping of logical parallel dims to physical mesh axis names.

    ``esp == mp`` (and non-empty) is the *merged* mode used on the
    production mesh: the ESP group coincides with the MP group, so the
    baseline schedule's ESP-AllGather materializes N_MP identical copies
    of the dispatch buffer -- exactly the redundancy Parm eliminates.
    """

    dp: tuple = ()   # pure data-parallel axes (gradient all-reduce)
    ep: tuple = ()   # expert-parallel axes (AlltoAll dispatch/combine)
    esp: tuple = ()  # expert-sharding axes (expert FFN hidden dim)
    mp: tuple = ()   # model-parallel axes

    def __post_init__(self):
        for f in ("dp", "ep", "esp", "mp"):
            v = getattr(self, f)
            if isinstance(v, str):
                object.__setattr__(self, f, (v,))
            else:
                object.__setattr__(self, f, tuple(v))

    @property
    def merged(self) -> bool:
        """True when the ESP group is the MP group (DeepSpeed-TED setting)."""
        return len(self.mp) > 0 and self.esp == self.mp

    @property
    def batch_axes(self) -> tuple:
        """Axes over which tokens are distinct at the MoE-layer boundary.

        In merged mode MP(==ESP) ranks hold replicated activations; in the
        distinct-axes mode, ESP ranks double as extra data parallelism
        (they hold different tokens)."""
        if self.merged:
            return self.dp + self.ep
        return self.dp + self.ep + self.esp

    def sizes(self, mesh) -> dict:
        return {
            "dp": axis_size(mesh, self.dp),
            "ep": axis_size(mesh, self.ep),
            "esp": axis_size(mesh, self.esp),
            "mp": axis_size(mesh, self.mp),
        }

    def validate(self, mesh, n_experts: int) -> None:
        for a in self.dp + self.ep + self.esp + self.mp:
            if a not in mesh.shape:
                raise ValueError(f"axis {a!r} not in mesh {mesh.shape}")
        n_ep = axis_size(mesh, self.ep)
        if n_experts % max(n_ep, 1) != 0:
            raise ValueError(
                f"E={n_experts} must be divisible by EP degree {n_ep}")


def production_dims(multi_pod: bool = False, moe: bool = True) -> ParallelDims:
    """Logical dims for the ``(data, model)`` / ``(pod, data, model)``
    meshes: MoE archs put EP over ``data`` and ESP == MP over ``model``;
    the ``pod`` axis is pure DP.  Dense archs: MP over ``model``,
    everything else DP."""
    dp = ("pod",) if multi_pod else ()
    if moe:
        return ParallelDims(dp=dp, ep=("data",), esp=("model",), mp=("model",))
    return ParallelDims(dp=dp + ("data",), ep=(), esp=(), mp=("model",))


def _ravel(coords, sizes) -> int:
    i = 0
    for c, s in zip(coords, sizes):
        i = i * s + c
    return i


@dataclass(frozen=True)
class AxisGroup:
    """The ranks that differ from this one only on ``axes``, seen from
    this rank.  ``index`` is this rank's JAX ``axis_index(axes)``
    (row-major in the tuple's order); ``order[g]`` the JAX index of the
    member at group position ``g`` (positions run in global-rank order);
    ``pg`` the process group (None when ``size == 1`` or on a mesh made
    for layout arithmetic only)."""
    axes: tuple
    size: int
    index: int
    order: tuple
    pg: object = None

    @property
    def identity_order(self) -> bool:
        return self.order == tuple(range(self.size))


class Mesh:
    """The ranks ``0 .. prod(shape) - 1`` laid out row-major over the named
    axes (rank ``r`` at ``unravel(r, shape)``), as ``jax.make_mesh`` lays
    out its devices.  ``shape`` maps axis name -> size, as a JAX mesh's
    does.

    With ``groups=True`` (as :func:`make_mesh` builds it on an initialised
    ``torch.distributed``) every rank creates one process group, on the
    default group's backend, for each subset of the axes and each of its
    cosets, in one fixed order; without, the mesh is for layout
    arithmetic only (``sharding.local_shard`` of any rank)."""

    def __init__(self, shape, names, rank: int = 0, *,
                 groups: bool = False):
        shape, names = tuple(int(s) for s in shape), tuple(names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} / names {names}")
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.devices_shape = shape
        self.size = math.prod(shape)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords = dict(zip(names, self._unravel(rank)))
        self._pgs = {}
        self._groups = {}
        self.has_groups = groups
        if groups:
            self._make_groups()

    def _unravel(self, r):
        out = []
        for s in reversed(self.devices_shape):
            out.append(r % s)
            r //= s
        return tuple(reversed(out))

    def _members(self, subset, rank):
        """Global ranks that share ``rank``'s coordinates off ``subset``."""
        base = dict(zip(self.axis_names, self._unravel(rank)))
        ranges = [range(self.shape[a]) if a in subset else (base[a],)
                  for a in self.axis_names]
        return sorted(_ravel(c, self.devices_shape)
                      for c in itertools.product(*ranges))

    def _make_groups(self):
        import torch.distributed as dist
        for k in range(1, len(self.axis_names) + 1):
            for subset in itertools.combinations(self.axis_names, k):
                if axis_size(self, subset) == 1:
                    continue
                seen = set()
                for r in range(self.size):
                    members = tuple(self._members(subset, r))
                    if members in seen:
                        continue
                    seen.add(members)
                    pg = dist.new_group(list(members))
                    if self.rank in members:
                        self._pgs[subset] = pg

    def group(self, axes) -> AxisGroup:
        """The :class:`AxisGroup` of ``axes`` (a name or a tuple, in the
        order JAX would name them) for this rank."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes in self._groups:
            return self._groups[axes]
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} not in mesh {self.shape}")
        if len(set(axes)) != len(axes):
            raise ValueError(f"repeated axis in {axes}")
        sizes = [self.shape[a] for a in axes]
        n = math.prod(sizes)
        subset = tuple(a for a in self.axis_names if a in axes)

        def jax_index(r):
            c = dict(zip(self.axis_names, self._unravel(r)))
            return _ravel([c[a] for a in axes], sizes)

        order = tuple(jax_index(r) for r in self._members(subset, self.rank))
        pg = None
        if n > 1 and self.has_groups:
            if subset not in self._pgs:
                raise RuntimeError(
                    f"mesh {self.shape} has no process group for {axes}: "
                    "make it with groups=True on an initialised "
                    "torch.distributed")
            pg = self._pgs[subset]
        g = AxisGroup(axes=axes, size=n, index=jax_index(self.rank),
                      order=order, pg=pg)
        self._groups[axes] = g
        return g

    def members(self, axes) -> list:
        """The global ranks of this rank's group over ``axes``, sorted."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self._members(tuple(a for a in self.axis_names if a in axes),
                             self.rank)

    def axis_index(self, axes) -> int:
        """JAX's ``lax.axis_index(axes)`` for this rank."""
        return self.group(axes).index if axes else 0

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def _dist_ready() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def make_mesh(shape, names) -> Mesh:
    """The mesh over the initialised default ``torch.distributed`` group
    (its world size must be ``prod(shape)``), with every axis subset's
    process groups made; on an uninitialised process, a one-rank mesh
    (``prod(shape)`` must be 1)."""
    n = math.prod(shape)
    if not _dist_ready():
        if n != 1:
            raise RuntimeError(f"a mesh of {n} ranks needs an initialised "
                               "torch.distributed (launch.mesh."
                               "init_distributed)")
        return Mesh(shape, names, 0)
    import torch.distributed as dist
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {tuple(shape)} has {n} ranks, the default "
                         f"group {dist.get_world_size()}")
    return Mesh(shape, names, dist.get_rank(), groups=n > 1)
