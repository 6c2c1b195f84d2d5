"""Meta rules of the port's kernels: what each op does to a tensor on the
``meta`` device, where the dry run (``launch/dryrun.py``) traces a step.

A meta tensor has a shape and a dtype and no data, so no kernel launches
and no plain version runs on it (the plain versions cannot: the dispatch
plans its passes from a host read of the slots, ``ref.scatter_rows_in_order``).
Each wrapper hands a meta call to its rule here, which returns empty meta
outputs of the kernel's shapes and dtypes and charges the kernel's
floating-point operations and bytes to every active :func:`counting`
context.  The figures are the bound column's of ``chip_smoke.py`` phase
3, computed from the shapes alone:

  * ``expert_ffn_grouped`` routes exactly ``S * k`` rows (the dropless
    path's count does not depend on the data), every expert's weights
    read once;
  * ``expert_ffn`` and ``expert_ffn_ragged`` run their whole capacity,
    and ``moe_combine`` reads every choice: upper bounds, since the
    routed rows depend on the data;
  * ``flash_attention`` counts the (query, key) pairs its causal and
    window masks keep.

A backward that recomputes through the plain version (``registry.
_RecomputeVJP``) charges :func:`backward` on meta: three times the
forward (the recompute, then the transposed products, two for each
forward product), and returns empty gradients; the live memory of the
recompute's temporaries is not seen.  A rule launches nothing and counts
no launch.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

_ACTIVE: list = []


@contextlib.contextmanager
def counting():
    """Sum the meta rules' charges inside into the yielded dict:
    ``flops``, ``bytes`` and ``by_op`` (op name -> [calls, flops,
    bytes])."""
    acc = {"flops": 0.0, "bytes": 0.0, "by_op": {}}
    _ACTIVE.append(acc)
    try:
        yield acc
    finally:
        _ACTIVE.remove(acc)


def charge(name: str, flops: float, nbytes: float) -> None:
    """Add one call of ``name`` to every active :func:`counting`."""
    for acc in _ACTIVE:
        acc["flops"] += flops
        acc["bytes"] += nbytes
        rec = acc["by_op"].setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes


def _es(t) -> int:
    return t.element_size()


def _empty(shape, like, dtype=None):
    return torch.empty(shape, dtype=dtype or like.dtype, device="meta")


def rmsnorm_cost(x, scale):
    R, D = x.shape
    return 4 * R * D, 2 * R * D * _es(x) + D * 4


def rmsnorm(x, scale):
    charge("rmsnorm", *rmsnorm_cost(x, scale))
    return _empty(x.shape, x)


def attention_pairs(Lq: int, Lk: int, causal: bool, window) -> int:
    """The (query, key) pairs the masks keep: query ``q`` sees keys ``kk
    <= q`` (causal) with ``q - kk < window``, positions from 0 on both
    sides as ``ref.flash_attention_ref`` aligns them (numpy: no torch op
    for a tracing mode to see)."""
    q = np.arange(Lq, dtype=np.int64)
    hi = np.minimum(q + 1, Lk) if causal else np.full_like(q, Lk)
    lo = np.maximum(q - int(window) + 1, 0) if window is not None \
        else np.zeros_like(q)
    return int(np.maximum(hi - lo, 0).sum())


def flash_attention_cost(q, k, v, causal=True, window=None):
    B, Lq, H, hd = q.shape
    Lk, K = k.shape[1], k.shape[2]
    pairs = attention_pairs(Lq, Lk, causal, window) * B * H
    return 4 * pairs * hd, B * (2 * Lq * H + 2 * Lk * K) * hd * _es(q)


def flash_attention(q, k, v, causal=True, window=None):
    charge("flash_attention", *flash_attention_cost(q, k, v, causal, window))
    return _empty(q.shape, q)


def moe_dispatch_cost(x, flat_idx, n_slots):
    S, M = x.shape
    k = flat_idx.shape[1]
    return S * k * M, S * M * _es(x) + S * k * 4 + n_slots * M * _es(x)


def moe_dispatch(x, flat_idx, n_slots):
    charge("moe_dispatch", *moe_dispatch_cost(x, flat_idx, n_slots))
    return _empty((int(n_slots), x.shape[1]), x)


def moe_combine_cost(buf, flat_idx, weights):
    M = buf.shape[1]
    S, k = flat_idx.shape
    kept = S * k                       # upper bound: every choice kept
    return 2 * kept * M, kept * M * _es(buf) + S * k * 8 + S * M * _es(buf)


def moe_combine(buf, flat_idx, weights):
    charge("moe_combine", *moe_combine_cost(buf, flat_idx, weights))
    return _empty((flat_idx.shape[0], buf.shape[1]), buf)


def _n_mat(w3) -> int:
    return 3 if w3 is not None else 2


def expert_ffn_cost(x, w1, w3, w2):
    E, T, M = x.shape
    F = w1.shape[2]
    n = _n_mat(w3)
    return (2 * n * E * T * M * F,
            2 * E * T * M * _es(x) + n * E * M * F * _es(w1))


def expert_ffn(x, w1, w3, w2):
    charge("expert_ffn", *expert_ffn_cost(x, w1, w3, w2))
    return _empty(x.shape, x, torch.promote_types(x.dtype, w1.dtype))


def expert_ffn_ragged_cost(xb, counts, w1, w3, w2):
    E, G, c, M = xb.shape
    F = w1.shape[2]
    n = _n_mat(w3)
    routed = E * G * c                 # upper bound: the whole capacity
    return (2 * n * routed * M * F,
            2 * routed * M * _es(xb) + E * G * 4 + n * E * M * F * _es(w1))


def expert_ffn_ragged(xb, counts, w1, w3, w2):
    charge("expert_ffn_ragged",
           *expert_ffn_ragged_cost(xb, counts, w1, w3, w2))
    return _empty(xb.shape, xb)


def expert_ffn_grouped_cost(x, flat_idx, weights, w1, w3, w2):
    S, M = x.shape
    k = flat_idx.shape[1]
    E, _, F = w1.shape
    n = _n_mat(w3)
    routed = S * k                     # exact: dropless
    hit = min(E, routed)
    return (2 * n * routed * M * F,
            2 * S * M * _es(x) + 2 * S * k * 4 + hit * n * M * F * _es(w1))


def expert_ffn_grouped(x, flat_idx, weights, w1, w3, w2):
    charge("expert_ffn_grouped",
           *expert_ffn_grouped_cost(x, flat_idx, weights, w1, w3, w2))
    return _empty(x.shape, x)


#: op name -> its forward cost function, on the op's tensor arguments
COST = {"rmsnorm": rmsnorm_cost, "flash_attention": flash_attention_cost,
        "moe_dispatch": moe_dispatch_cost, "moe_combine": moe_combine_cost,
        "expert_ffn": expert_ffn_cost,
        "expert_ffn_ragged": expert_ffn_ragged_cost,
        "expert_ffn_grouped": expert_ffn_grouped_cost}


def backward(name: str, args, static: dict, needs) -> list:
    """A recompute backward on meta: charges three times the forward's
    operations and bytes under ``<name>.bwd`` and returns an empty
    gradient for each argument in ``needs`` (None for the others)."""
    kw = {k: static[k] for k in ("causal", "window") if k in static}
    flops, nbytes = COST[name](*args, **kw)
    charge(f"{name}.bwd", 3 * flops, 3 * nbytes)
    return [torch.empty_like(a) if need else None
            for a, need in zip(args, needs)]
