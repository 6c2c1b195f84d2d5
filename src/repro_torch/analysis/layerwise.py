"""Cost accounting of one step for the roofline (counterpart of
``repro/analysis/layerwise.py``).

JAX's module lowers one block per run and multiplies its cost by the run's
length because XLA's ``cost_analysis`` counts a ``lax.scan`` body once,
not times its trip count.  The port has no scan: its eager step runs
every layer, so the whole step is counted as it runs, once, on the meta
device as one rank of the mesh (``torch.distributed``'s fake backend
under ``launch/dryrun.py``), backward and optimizer included for
``train``:

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` for the aten ops
    (matrix products), plus the kernels' meta rules
    (``kernels/meta.py``);
  * bytes: every aten op's input and output bytes (a view moves none, an
    empty allocation none), plus the meta rules';
  * live memory: the peak of the meta storage the step's ops allocate
    (freed when its last tensor goes), beside the arguments allocated
    before it;
  * collectives: ``parallel.comm.timing``'s result bytes by kind, under
    XLA's HLO names (:data:`HLO_KIND`), and by group.

Nothing is allocated and no data moves: the counts come from shapes.
"""

from __future__ import annotations

import math
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: the port's collectives (``parallel.comm``) -> XLA's HLO op names
HLO_KIND = {"all_to_all": "all-to-all", "all_to_all_rows": "all-to-all",
            "permute_rows": "collective-permute",
            "all_gather": "all-gather", "psum_scatter": "reduce-scatter",
            "psum": "all-reduce", "pmax": "all-reduce"}
#: allocations that move no bytes
_EMPTY = {"aten::empty", "aten::empty_strided", "aten::empty_like",
          "aten::new_empty", "aten::new_empty_strided"}


class _Tally(TorchDispatchMode):
    """Sums every aten op's input and output bytes and tracks the live
    storage the ops allocate: its peak is the step's temporary memory."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held = {}

    def _free(self, key):
        self.live -= self._held.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rets = func._schema.returns
        aliased = any(r.alias_info is not None for r in rets)
        written = any(r.alias_info is not None and r.alias_info.is_write
                      for r in rets)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if (written or not aliased) and func._schema.name not in _EMPTY:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        if not aliased:
            for t in outs:
                st = t.untyped_storage()
                key = st._cdata
                if key in self._held:
                    continue
                self._held[key] = st.nbytes()
                self.live += st.nbytes()
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, key)
        return out


def _check_storage_lifetime() -> None:
    """The tally frees a storage when its Python object is collected,
    which holds only where torch keeps that object alive as long as the
    storage (it does since 2.x); raise where it does not, rather than
    report a peak that forgets every allocation at once."""
    t = torch.empty(4, device="meta")
    fired = []
    weakref.finalize(t.untyped_storage(), fired.append, 1)
    alive = not fired
    del t
    if not alive or not fired:
        raise RuntimeError(f"torch {torch.__version__}: a storage's Python "
                           "object does not live as long as the storage; "
                           "the dry run cannot track live memory")


def measure(fn):
    """Run ``fn()`` (a step on meta tensors) under the counters.  Returns
    ``(fn's result, costs)``: ``flops``, ``bytes``, ``coll`` (result
    bytes of every collective), ``coll_by_kind`` and ``coll_counts``
    (HLO names), ``coll_by_group`` (axes -> bytes), ``peak_bytes`` (the
    live storage's peak), ``kernels`` (op -> [calls, flops, bytes] of the
    meta rules) and ``trace_s``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import meta
    from repro_torch.parallel import comm
    _check_storage_lifetime()
    tally = _Tally()
    comm.timing(True)
    try:
        t0 = time.perf_counter()
        with meta.counting() as kc, \
                FlopCounterMode(display=False) as fc, tally:
            out = fn()
        trace_s = time.perf_counter() - t0
        counts, by_kind, by_group = {}, {}, {}
        calls = comm.times()
        for name, groups in comm.bytes_out().items():
            kind = HLO_KIND[name]
            counts[kind] = counts.get(kind, 0) + calls[name][0]
            for axes, b in groups.items():
                by_kind[kind] = by_kind.get(kind, 0) + b
                by_group[axes] = by_group.get(axes, 0) + b
    finally:
        comm.timing(False)
    return out, {"flops": float(fc.get_total_flops() + kc["flops"]),
                 "bytes": float(tally.bytes + kc["bytes"]),
                 "coll": float(sum(by_kind.values())),
                 "coll_by_kind": by_kind, "coll_counts": counts,
                 "coll_by_group": by_group, "peak_bytes": tally.peak,
                 "kernels": kc["by_op"], "trace_s": trace_s}


# --- the step's state on the meta device -------------------------------------

def _meta_like(t, shape=None):
    return torch.empty(t.shape if shape is None else shape, dtype=t.dtype,
                       device="meta")


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def full_param_shapes(cfg) -> dict:
    """Every parameter of ``cfg`` at its full shape, as meta tensors:
    ``Model.init`` run under ``FakeTensorMode``, which allocates
    nothing (``init`` draws from a generator, and the meta device has
    none)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.model import Model
    with FakeTensorMode():
        fake = Model(cfg, "cpu").init(torch.Generator())
    return _map(_meta_like, fake)


def count_params(shapes) -> int:
    from repro_torch.optim.adamw import leaves
    return sum(math.prod(t.shape) for t in leaves(shapes))


def local_batch(cfg, shape, mesh, dims) -> dict:
    """``input_specs`` of ``shape`` on the meta device, cut to this rank's
    rows where the batch axes divide the global batch (JAX's dry run
    shards a leaf whose dim 0 is the batch so; the others whole)."""
    from repro_torch.configs.base import input_specs
    from repro_torch.parallel.mesh import axis_size
    baxes = tuple(dims.batch_axes)
    nb = axis_size(mesh, baxes) if baxes else 1
    B = shape.global_batch

    def rows(t):
        if baxes and t.dim() and t.shape[0] == B and B % nb == 0:
            return _meta_like(t, (B // nb, *t.shape[1:]))
        return t
    return {k: rows(v) for k, v in input_specs(cfg, shape).items()}


def meta_state(model, mesh, dims, shape, *, zero_axes=(),
               seq_shard=False, full=None) -> dict:
    """One rank's arguments of ``shape``'s step on the meta device:
    ``params`` (this rank's shards, ``Model.param_specs``), ``opt_state``
    (AdamW, ZeRO-1 over ``zero_axes``) to train, ``cache`` and its
    ``cache_specs`` to decode (and a cross-attention arch's ``ctx_kv``,
    this rank's rows and kv heads, ``Model.ctx_kv`` on the meta device:
    JAX lowers it as an argument of the serve step), and ``batch`` (this
    rank's rows where the batch axes divide the batch, as JAX's dry run
    shards it).  ``full``: :func:`full_param_shapes`, if made already."""
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.parallel.sharding import local_shape
    from repro_torch.train.loop import cache_specs, zero1_layout
    cfg = model.cfg
    full = full if full is not None else full_param_shapes(cfg)
    specs = model.param_specs(full, mesh, dims)
    params = _map(lambda t, s: _meta_like(t, local_shape(t.shape, s, mesh)),
                  full, specs)
    B = shape.global_batch
    state = {"params": params, "opt_state": None, "cache": None,
             "c_specs": None, "ctx_kv": None,
             "batch": local_batch(cfg, shape, mesh, dims)}
    if shape.kind == "train":
        state["opt_state"] = adamw_init(
            params, zero=zero1_layout(model, params, mesh, dims, zero_axes),
            mesh=mesh)
    elif shape.kind == "decode":
        c_specs = cache_specs(model, mesh, dims, B, shape.seq_len,
                              seq_shard=seq_shard)
        state["c_specs"] = c_specs
        state["cache"] = model.init_cache(
            B, shape.seq_len, getattr(torch, cfg.dtype), mesh=mesh,
            dims=dims, specs=c_specs)
        if model.has_cross:
            with torch.no_grad():
                state["ctx_kv"] = model.ctx_kv(params, state["batch"],
                                               mesh=mesh, dims=dims)
    return state


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensors (dicts, and a recurrent cache's
    tuples)."""
    if tree is None:
        return 0
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def make_step(model, mesh, dims, shape, state, *, schedule=None,
              guards=False, zero_axes=()):
    """The step ``shape.kind`` runs on ``state`` (:func:`meta_state`), as
    a call of no arguments: ``make_train_step`` (or, with ``guards``,
    ``make_guarded_train_step`` at ``lr_scale`` 1 and no fault),
    ``make_prefill_fn`` or ``make_serve_step`` (with ``ctx_kv``, its
    fourth argument)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import loop
    p, b = state["params"], state["batch"]
    if shape.kind == "train":
        o = state["opt_state"]
        if guards:
            fn = loop.make_guarded_train_step(model, AdamWConfig(), schedule,
                                              mesh, dims, zero_axes)
            return lambda: fn(p, o, b, 1.0, 0.0)
        fn = loop.make_train_step(model, AdamWConfig(), schedule, mesh, dims,
                                  zero_axes)
        return lambda: fn(p, o, b)
    if shape.kind == "prefill":
        fn = loop.make_prefill_fn(model, mesh, dims, schedule)
        return lambda: fn(p, b)
    fn = loop.make_serve_step(model, mesh, dims, schedule,
                              specs=state["c_specs"])
    return lambda: fn(p, state["cache"], b, state["ctx_kv"])


def layerwise_costs(model, cfg, mesh, dims, shape, *, kind: str,
                    schedule=None) -> dict:
    """kind: 'train' | 'prefill' | 'decode'.  One rank's ``flops``,
    ``bytes``, ``coll`` and ``coll_by_kind`` of the whole step (JAX's
    keys), with :func:`measure`'s other counts beside them.  ``model``
    is a ``Model`` on the meta device and ``mesh`` a mesh over the fake
    backend (or one rank)."""
    if kind != shape.kind:
        raise ValueError(f"kind {kind!r} for a {shape.kind} shape")
    state = meta_state(model, mesh, dims, shape)
    _, costs = measure(make_step(model, mesh, dims, shape, state,
                                 schedule=schedule))
    return costs
