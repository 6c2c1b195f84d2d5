"""Dropless grouped expert FFN (counterpart of
``repro/kernels/expert_ffn_grouped.py``), in two forms:

``expert_ffn_grouped``
    One fused op: gather each expert's routed token rows, run the expert
    FFN in f32 and scatter the gate-weighted outputs back to token order.
    CUDA tensors go through ``csrc/expert_ffn_grouped.cu``; CPU tensors
    through the plain ``expert_ffn_grouped_ref``.  The routed-row metadata
    (``slot_metadata``) is built on the device in torch.
``expert_ffn_ragged``
    The FFN over an (E, G, c, M) pool with (E, G) routed-row counts: row
    tiles past a count are skipped and rows at or past it are exact zeros.
    CUDA tensors go through ``csrc/expert_ffn.cu``'s ragged entry point;
    CPU tensors through ``expert_ffn_ragged_ref``.

``expert_ffn_grouped.launches`` and ``expert_ffn_ragged.launches`` count
the CUDA ops' launches (one per call: each C entry point launches its
kernels together).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, meta
from repro_torch.kernels.expert_ffn import (ACT_CODE, check_weights,
                                            launch_ffn)
from repro_torch.kernels.ref import (expert_ffn_grouped_ref,
                                     expert_ffn_ragged_ref)

WIRE_CODE = {"f32": 0, "bf16": 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_C_ARGS = (_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
           _I, _I, _I, _I, _I, _I, _I, _I, _P)


@functools.cache
def _c_fn():
    fn = _build.library("expert_ffn_grouped").repro_expert_ffn_grouped
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    return fn


def slot_rows(flat_idx, n_tokens, n_experts, cap):
    """Invert the gate's (token -> slot) map: per-slot source row ids
    ``rid`` (E, cap) int32 (``n_tokens`` marks an empty slot) and
    per-expert routed-row counts (E,) int32.

    JAX's ``.at[flat].set(..., mode="drop")`` silently drops the drop
    sentinel ``E * cap``; torch indexing would raise on it, so the scatter
    goes into one extra row that is sliced off."""
    S, k = flat_idx.shape
    n = n_experts * cap
    dev = flat_idx.device
    src = torch.arange(S * k, dtype=torch.int32, device=dev) // k
    rid = torch.full((n + 1,), n_tokens, dtype=torch.int32, device=dev)
    rid[flat_idx.reshape(-1).long()] = src
    rid = rid[:n].reshape(n_experts, cap)
    counts = (rid < n_tokens).sum(dim=1, dtype=torch.int32)
    return rid, counts


def slot_metadata(flat_idx, weights, n_tokens, n_experts, cap):
    """``(rid, ws, counts)`` exactly as the JAX ``slot_metadata``: row ids
    and counts from :func:`slot_rows` plus per-slot f32 gate weights."""
    rid, counts = slot_rows(flat_idx, n_tokens, n_experts, cap)
    n = n_experts * cap
    ws = torch.zeros((n + 1,), dtype=torch.float32, device=flat_idx.device)
    ws[flat_idx.reshape(-1).long()] = weights.reshape(-1).float()
    return rid, ws[:n].reshape(n_experts, cap), counts


def _check(x, flat_idx, weights, w1, w3, w2, cap, act, wire):
    if x.dim() != 2:
        raise ValueError(f"expert_ffn_grouped: x must be (S, M), got "
                         f"{tuple(x.shape)}")
    S, M = x.shape
    E, F = check_weights("expert_ffn_grouped", x, M, w1, w3, w2, act)
    if flat_idx.dim() != 2 or flat_idx.shape[0] != S \
            or flat_idx.dtype != torch.int32:
        raise ValueError("expert_ffn_grouped: flat_idx must be int32 (S, k)")
    if weights.shape != flat_idx.shape or weights.dtype != torch.float32:
        raise ValueError("expert_ffn_grouped: weights must be float32 (S, k)")
    if wire not in WIRE_CODE:
        raise ValueError(f"expert_ffn_grouped: wire {wire!r} not supported "
                         f"({sorted(WIRE_CODE)})")
    if int(cap) <= 0 or E * int(cap) >= 2 ** 31:
        raise ValueError(f"expert_ffn_grouped: cap {cap} out of range")
    if any(t.get_device() != x.get_device() for t in (flat_idx, weights)):
        raise ValueError("expert_ffn_grouped: operands on different devices")
    if not (flat_idx.is_contiguous() and weights.is_contiguous()):
        raise ValueError("expert_ffn_grouped: operands must be contiguous")
    _build.check_aligned(
        "expert_ffn_grouped",
        {"x": M * x.element_size(), "w1/w3": F * w1.element_size(),
         "w2": M * w2.element_size(), "f32 scratch": F * 4},
        {"x": x, "w1": w1, "w3": w3, "w2": w2})


def expert_ffn_grouped(x, flat_idx, weights, w1, w3, w2, *, cap,
                       act="silu", wire="f32"):
    """Fused dispatch -> ragged FFN -> combine.  x: (S, M) float32 or
    bfloat16; flat_idx (S, k) int32 flat slots (``E * cap`` = dropped);
    weights (S, k) float32; w1/w3 (E, M, F), w2 (E, F, M) of one dtype (w3
    None for 2-layer experts).  Returns (S, M) in x's dtype."""
    if x.is_meta:
        return meta.expert_ffn_grouped(x, flat_idx, weights, w1, w3, w2)
    if not _build.on_card(x, "expert_ffn_grouped"):
        return expert_ffn_grouped_ref(x, flat_idx, weights, w1, w3, w2,
                                      cap=cap, act=act, wire=wire)
    _check(x, flat_idx, weights, w1, w3, w2, cap, act, wire)
    S, M = x.shape
    E, _, F = w1.shape
    k = flat_idx.shape[1]
    cap = int(cap)
    x_code = _build.dtype_code(x, "expert_ffn_grouped x")
    w_code = _build.dtype_code(w1, "expert_ffn_grouped weights")
    rid, counts = slot_rows(flat_idx, S, E, cap)
    mid = torch.empty((E * cap, F), dtype=torch.float32, device=x.device)
    hbuf = torch.empty((E * cap, M), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    err = _c_fn()(
        x.data_ptr(), x_code, flat_idx.data_ptr(), weights.data_ptr(),
        rid.data_ptr(), counts.data_ptr(), w1.data_ptr(),
        w3.data_ptr() if w3 is not None else None, w2.data_ptr(), w_code,
        mid.data_ptr(), hbuf.data_ptr(), y.data_ptr(), S, k, M, F, E, cap,
        ACT_CODE[act], WIRE_CODE[wire], _build.stream_ptr(x.get_device()))
    _build.check_launch(err, "expert_ffn_grouped")
    expert_ffn_grouped.launches += 1
    return y


expert_ffn_grouped.launches = 0


def expert_ffn_ragged(xb, counts, w1, w3, w2, *, act="silu"):
    """Ragged grouped FFN.  xb: (E, G, c, M) float32 or bfloat16; counts:
    (E, G) int32 routed rows per group; w1/w3 (E, M, F), w2 (E, F, M) of
    one dtype (w3 None for two-layer experts).  Returns (E, G, c, M) in
    xb's dtype, computed in f32, rows >= counts[e, g] exactly 0."""
    if xb.is_meta:
        return meta.expert_ffn_ragged(xb, counts, w1, w3, w2)
    if not _build.on_card(xb, "expert_ffn_ragged"):
        return expert_ffn_ragged_ref(xb, counts, w1, w3, w2, act=act)
    if xb.dim() != 4 or xb.shape[0] != w1.shape[0]:
        raise ValueError(f"expert_ffn_ragged: xb must be (E, G, c, M) with "
                         f"E = {w1.shape[0]}, got {tuple(xb.shape)}")
    E, G, c, M = xb.shape
    if counts.shape != (E, G) or counts.dtype != torch.int32 \
            or counts.get_device() != xb.get_device() \
            or not counts.is_contiguous():
        raise ValueError(f"expert_ffn_ragged: counts must be contiguous "
                         f"int32 ({E}, {G}) on xb's device, got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    y = launch_ffn("expert_ffn_ragged", xb, counts, w1, w3, w2, xb.dtype,
                   act, G, c)
    expert_ffn_ragged.launches += 1
    return y.reshape(E, G, c, M)


expert_ffn_ragged.launches = 0
