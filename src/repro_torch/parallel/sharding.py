"""Partition specs over the port's mesh (counterpart of
``repro/parallel/sharding.py``).

A :class:`PartitionSpec` is JAX's: one entry per array dim, each None
(replicated) or a tuple of mesh axis names (the dim split over their
product, row-major in the tuple's order).  ``ShardingRules``, ``maybe``
and ``divisible`` are the JAX module's.  The model's specs are JAX's
per-module functions (``attn_specs``, ``ffn_specs``, ``embedding_specs``,
``norm_specs``, ``moe_param_specs``, ``block_specs``, ``Model.param_specs``):
the dense layers Megatron-style over MP, the experts over EP and ESP.
JAX's ``Model.specs`` does not call ``ShardingRules`` either; its copy
gives the same specs for the same shapes (``tests/test_torch_mesh.py``).

:func:`local_shard` cuts a full array down to one rank's block, as
``jax.device_put`` with a ``NamedSharding`` does; :func:`gather_full` is
its inverse (AllGathers over each sharded dim), for tests and
checkpoint-free comparisons; :func:`gather_to_first` assembles the full
tensor on the first rank alone (a checkpoint's save).
:func:`replicated_axes` names the axes a spec does not mention: the axes
whose ranks hold the same block.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.parallel.mesh import ParallelDims, axis_size


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: a tuple, as JAX's is, so two specs
    compare equal entry by entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):           # pickle rebuilds it entry by entry
        return tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def maybe(axes):
    """Return axes tuple for a PartitionSpec entry, or None if empty."""
    axes = tuple(axes)
    return axes if axes else None


def divisible(n: int, mesh, axes) -> bool:
    return n % max(axis_size(mesh, axes), 1) == 0


class ShardingRules:
    """Derive PartitionSpecs for a model family given mesh + ParallelDims.

    Falls back to replication whenever a dim is not divisible by the axis
    size (e.g. GQA kv_heads=4 on a 16-way model axis).
    """

    def __init__(self, mesh, dims: ParallelDims):
        self.mesh = mesh
        self.dims = dims

    def _mp(self, dim_size: int):
        mp = self.dims.mp
        if mp and dim_size % axis_size(self.mesh, mp) == 0:
            return maybe(mp)
        return None

    def act_tokens(self):
        """(B, L, M) activations: batch over DP+EP, replicated over MP."""
        return P(maybe(self.dims.batch_axes), None, None)

    def act_kv_cache(self, n_kv: int):
        """(B, n_kv, L, hd) decode cache."""
        return P(maybe(self.dims.batch_axes), self._mp(n_kv), None, None)

    def dense(self, shape, mp_dim: int | None):
        """Generic dense weight; shard dim ``mp_dim`` over MP if divisible."""
        spec = [None] * len(shape)
        if mp_dim is not None:
            spec[mp_dim] = self._mp(shape[mp_dim])
        return P(*spec)

    def expert(self, shape_e_first, esp_dim: int):
        """Stacked expert weight (E, ...): E over EP, ``esp_dim`` over ESP."""
        spec = [None] * len(shape_e_first)
        ep = self.dims.ep
        if ep and shape_e_first[0] % axis_size(self.mesh, ep) == 0:
            spec[0] = maybe(ep)
        esp = self.dims.esp
        if esp and shape_e_first[esp_dim] % axis_size(self.mesh, esp) == 0:
            spec[esp_dim] = maybe(esp)
        return P(*spec)


def _entry(e):
    return () if e is None else ((e,) if isinstance(e, str) else tuple(e))


def mentioned(spec) -> tuple:
    """The mesh axes a spec shards over, in spec order."""
    return tuple(a for e in spec for a in _entry(e))


def replicated_axes(spec, mesh) -> tuple:
    """The mesh axes ``spec`` does not mention (JAX's unmentioned axes),
    in mesh order."""
    used = set(mentioned(spec))
    return tuple(a for a in mesh.axis_names if a not in used)


def _block(mesh, entry, n_dim):
    """(start, size) of this rank's block of a dim of ``n_dim`` split over
    the axes of ``entry``."""
    axes = _entry(entry)
    n = axis_size(mesh, axes)
    if n_dim % n:
        raise ValueError(f"dim of {n_dim} not divisible by {axes} ({n})")
    idx = mesh.group(axes).index if axes else 0
    return idx * (n_dim // n), n_dim // n


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of this rank's block of an array of ``shape`` under
    ``spec`` (what :func:`local_shard` cuts, without the array)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            out[d] = _block(mesh, entry, shape[d])[1]
    return tuple(out)


def local_shard(array, spec, mesh):
    """This rank's block of the full ``array`` (numpy or tensor) under
    ``spec``: a view (numpy) or a contiguous copy (tensor)."""
    if len(spec) > array.ndim:
        raise ValueError(f"spec {spec} for an array of {array.ndim} dims")
    out = array
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        start, size = _block(mesh, entry, array.shape[d])
        if isinstance(out, np.ndarray):
            out = out[(slice(None),) * d + (slice(start, start + size),)]
        else:
            out = out.narrow(d, start, size)
    return out.contiguous() if isinstance(out, torch.Tensor) else out


def local_tree(tree, specs, mesh):
    """:func:`local_shard` over a nested dict of arrays and one of specs."""
    if isinstance(tree, dict):
        return {k: local_tree(v, specs[k], mesh) for k, v in tree.items()}
    return local_shard(tree, specs, mesh)


def gather_full(tensor, spec, mesh):
    """Inverse of :func:`local_shard`: the full tensor on every rank, from
    each rank's block (tiled AllGathers over every sharded dim)."""
    from repro_torch.parallel import comm
    out = tensor
    for d, entry in enumerate(spec):
        axes = _entry(entry)
        if axes and axis_size(mesh, axes) > 1:
            out = comm.all_gather(out.contiguous(), mesh.group(axes), d)
    return out


def gather_to_first(tensor, spec, mesh):
    """The full tensor on the mesh's first rank (rank 0), None on the
    others: each distinct block once, from the rank that holds it at
    coordinate 0 on every axis ``spec`` does not name, placed where
    :func:`local_shard` cut it; the other ranks receive and keep
    nothing."""
    from repro_torch.parallel import comm
    from repro_torch.parallel.mesh import Mesh
    used = set(mentioned(spec))
    layouts = [Mesh(mesh.devices_shape, mesh.axis_names, r)
               for r in range(mesh.size)]
    holds = [all(m.coords[a] == 0 for a in mesh.axis_names if a not in used)
             for m in layouts]
    blocks = comm.gather_first(tensor, mesh.group(mesh.axis_names), holds)
    if blocks is None:
        return None
    entries = list(spec) + [None] * (tensor.dim() - len(spec))
    shape = [n * axis_size(mesh, _entry(e)) for n, e in
             zip(tensor.shape, entries)]
    full = tensor.new_empty(shape)
    for m, block in zip(layouts, blocks):
        if block is not None:
            full[tuple(slice(start, start + size) for start, size in
                       (_block(m, e, n) for e, n in zip(entries, shape)))] \
                = block
    return full
