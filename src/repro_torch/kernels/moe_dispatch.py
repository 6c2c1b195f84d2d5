"""MoE dispatch scatter and combine gather (counterpart of
``repro/kernels/moe_dispatch.py``): CUDA kernels (``csrc/moe_dispatch.cu``)
for tensors on the card, the plain PyTorch versions for tensors on the
CPU.

``moe_dispatch.launches`` and ``moe_combine.launches`` count the CUDA
kernels' launches.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch

from repro_torch.kernels import _build, meta
from repro_torch.kernels.ref import moe_combine_ref, moe_dispatch_ref

#: the C entry points' one argument each (``DispatchArgs``, ``CombineArgs``
#: in ``csrc/moe_dispatch.cu``): x, flat, buf, stream, dtype, S, k, M,
#: n_slots; and buf, flat, weights, y, stream, dtype, S, k, M, n_slots
_DISPATCH_ARGS = struct.Struct("PPPPiiiii4x").pack
_COMBINE_ARGS = struct.Struct("PPPPPiiiii4x").pack


@functools.cache
def _c_fns():
    lib = _build.library("moe_dispatch")
    disp, comb = lib.repro_moe_dispatch, lib.repro_moe_combine
    disp.restype = comb.restype = ctypes.c_int  # bytes pass as a pointer
    return disp, comb


def _check_flat(what, flat_idx, S, dev):
    if flat_idx.dim() != 2 or flat_idx.shape[0] != S \
            or flat_idx.dtype != torch.int32:
        raise ValueError(f"{what}: flat_idx must be int32 (S, k) with S = "
                         f"{S}, got {flat_idx.dtype} "
                         f"{tuple(flat_idx.shape)}")
    if flat_idx.get_device() != dev:
        raise ValueError(f"{what}: operands on different devices")


def moe_dispatch(x, flat_idx, n_slots):
    """Scatter tokens into the flat capacity buffer.  x: (S, M) float32 or
    bfloat16; flat_idx: (S, k) int32 slots in [0, n_slots] (``n_slots`` =
    dropped).  Returns (n_slots, M) in x's dtype.  A slot that several
    choices name holds their sum, taken from 0 in token order, then choice
    order, rounded to x's dtype after each addition (the Pallas kernel's
    order); a slot no choice names is 0."""
    if x.is_meta:
        return meta.moe_dispatch(x, flat_idx, n_slots)
    if not _build.on_card(x, "moe_dispatch"):
        return moe_dispatch_ref(x, flat_idx, n_slots)
    if x.dim() != 2:
        raise ValueError(f"moe_dispatch: x must be (S, M), got "
                         f"{tuple(x.shape)}")
    S, M = x.shape
    dev = x.get_device()
    _check_flat("moe_dispatch", flat_idx, S, dev)
    n_slots = int(n_slots)
    if not 0 <= n_slots < 2 ** 31:
        raise ValueError(f"moe_dispatch: n_slots {n_slots} out of range")
    if not (x.is_contiguous() and flat_idx.is_contiguous()):
        raise ValueError("moe_dispatch: operands must be contiguous")
    code = _build.dtype_code(x, "moe_dispatch")
    buf = x.new_empty((n_slots, M))
    if n_slots == 0:        # nothing to write: no launch
        return buf
    err = _c_fns()[0](_DISPATCH_ARGS(
        x.data_ptr(), flat_idx.data_ptr(), buf.data_ptr(),
        _build.stream_ptr(dev), code, S, flat_idx.shape[1], M, n_slots))
    _build.check_launch(err, "moe_dispatch")
    moe_dispatch.launches += 1
    return buf


def moe_combine(buf, flat_idx, weights):
    """Gather expert outputs back to tokens.  buf: (n_slots, M) float32 or
    bfloat16; flat_idx: (S, k) int32; weights: (S, k) float32.  Returns
    (S, M) in buf's dtype: sum_j weights[s, j] * buf[flat_idx[s, j]] in f32,
    dropped choices adding nothing."""
    if buf.is_meta:
        return meta.moe_combine(buf, flat_idx, weights)
    if not _build.on_card(buf, "moe_combine"):
        return moe_combine_ref(buf, flat_idx, weights)
    if buf.dim() != 2:
        raise ValueError(f"moe_combine: buf must be (n_slots, M), got "
                         f"{tuple(buf.shape)}")
    n_slots, M = buf.shape
    S = flat_idx.shape[0]
    dev = buf.get_device()
    _check_flat("moe_combine", flat_idx, S, dev)
    if weights.shape != flat_idx.shape or weights.dtype != torch.float32 \
            or weights.get_device() != dev:
        raise ValueError("moe_combine: weights must be float32 (S, k) on "
                         "buf's device")
    if not (buf.is_contiguous() and flat_idx.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("moe_combine: operands must be contiguous")
    code = _build.dtype_code(buf, "moe_combine")
    y = buf.new_empty((S, M))
    err = _c_fns()[1](_COMBINE_ARGS(
        buf.data_ptr(), flat_idx.data_ptr(), weights.data_ptr(),
        y.data_ptr(), _build.stream_ptr(dev), code, S, flat_idx.shape[1], M,
        n_slots))
    _build.check_launch(err, "moe_combine")
    moe_combine.launches += 1
    return y


moe_dispatch.launches = 0
moe_combine.launches = 0
