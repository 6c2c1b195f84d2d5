"""Expert FFN over a capacity buffer (counterpart of
``repro/kernels/expert_ffn.py``): a CUDA kernel (``csrc/expert_ffn.cu``,
entry point ``repro_expert_ffn``) for tensors on the card, the plain
``expert_ffn_ref`` for tensors on the CPU.  The same source's ragged entry
point backs ``expert_ffn_grouped.expert_ffn_ragged``; both go through
:func:`launch_ffn`.

``expert_ffn.launches`` counts the CUDA op's launches (one per call: the C
entry point launches its up and down kernels together).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, meta
from repro_torch.kernels.ref import expert_ffn_ref

ACT_CODE = {"silu": 0, "gelu": 1}

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _c_fns():
    lib = _build.library("expert_ffn")
    dense, ragged = lib.repro_expert_ffn, lib.repro_expert_ffn_ragged
    dense.argtypes = (_P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                      _P)
    ragged.argtypes = (_P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                       _I, _I, _P)
    dense.restype = ragged.restype = ctypes.c_int
    return dense, ragged


def check_weights(what, x, M, w1, w3, w2, act):
    """Validate (E, M, F) / (E, F, M) expert weights against rows of width
    ``M`` on ``x``'s device; returns (E, F)."""
    if w1.dim() != 3 or w2.dim() != 3:
        raise ValueError(f"{what}: w1 (E, M, F) and w2 (E, F, M)")
    E, _, F = w1.shape
    if w1.shape != (E, M, F) or w2.shape != (E, F, M):
        raise ValueError(f"{what}: weight shapes {tuple(w1.shape)} / "
                         f"{tuple(w2.shape)} do not fit rows of width {M}")
    if w3 is not None and (w3.shape != w1.shape or w3.dtype != w1.dtype):
        raise ValueError(f"{what}: w3 must match w1")
    if w2.dtype != w1.dtype:
        raise ValueError(f"{what}: w1 and w2 dtypes differ")
    if act not in ACT_CODE:
        raise ValueError(f"{what}: act {act!r} not supported "
                         f"({sorted(ACT_CODE)})")
    ws = [w1, w2] + ([w3] if w3 is not None else [])
    if any(t.get_device() != x.get_device() for t in ws):
        raise ValueError(f"{what}: operands on different devices")
    if not all(t.is_contiguous() for t in [x, *ws]):
        raise ValueError(f"{what}: operands must be contiguous")
    return E, F


def launch_ffn(what, x, counts, w1, w3, w2, out_dtype, act, groups, rows):
    """Run the CUDA FFN over ``groups`` groups of ``rows`` rows per expert:
    the dense entry point when ``counts`` is None, else the ragged one
    (output in x's dtype).  Returns the (E * groups * rows, M) output.
    Rows and start addresses must be 16-byte aligned (the kernels copy
    with 16-byte ``cp.async``): anything else raises ``ValueError``."""
    M = x.shape[-1]
    E, F = check_weights(what, x, M, w1, w3, w2, act)
    if E * groups * rows >= 2 ** 31 or -(-rows // 16) > 65535 \
            or E * groups > 65535:
        raise ValueError(f"{what}: {E} x {groups} x {rows} rows out of the "
                         f"kernel's grid")
    x_code = _build.dtype_code(x, f"{what} x")
    w_code = _build.dtype_code(w1, f"{what} weights")
    y_code = _build.DTYPE_CODE[out_dtype]
    _build.check_aligned(
        what, {"x": M * x.element_size(), "w1/w3": F * w1.element_size(),
               "w2": M * w2.element_size(), "f32 scratch": F * 4},
        {"x": x, "w1": w1, "w3": w3, "w2": w2})
    mid = torch.empty((E * groups * rows, F), dtype=torch.float32,
                      device=x.device)
    y = torch.empty((E * groups * rows, M), dtype=out_dtype, device=x.device)
    w3p = w3.data_ptr() if w3 is not None else None
    stream = _build.stream_ptr(x.get_device())
    dense, ragged = _c_fns()
    if counts is None:
        err = dense(x.data_ptr(), x_code, w1.data_ptr(), w3p, w2.data_ptr(),
                    w_code, mid.data_ptr(), y.data_ptr(), y_code, E, rows, M,
                    F, ACT_CODE[act], stream)
    else:
        err = ragged(x.data_ptr(), x_code, counts.data_ptr(), w1.data_ptr(),
                     w3p, w2.data_ptr(), w_code, mid.data_ptr(), y.data_ptr(),
                     E, groups, rows, M, F, ACT_CODE[act], stream)
    _build.check_launch(err, what)
    return y


def expert_ffn(x, w1, w3, w2, *, act="silu"):
    """Per-expert FFN over a capacity buffer.  x: (E, T, M); w1/w3:
    (E, M, F); w2: (E, F, M) (w3 None for two-layer experts), float32 or
    bfloat16.  Returns (E, T, M) in the promoted dtype of x and the
    weights, computed in f32."""
    if x.is_meta:
        return meta.expert_ffn(x, w1, w3, w2)
    if not _build.on_card(x, "expert_ffn"):
        return expert_ffn_ref(x, w1, w3, w2, act=act)
    if x.dim() != 3 or x.shape[0] != w1.shape[0]:
        raise ValueError(f"expert_ffn: x must be (E, T, M) with E = "
                         f"{w1.shape[0]}, got {tuple(x.shape)}")
    E, T, M = x.shape
    out_dtype = torch.promote_types(x.dtype, w1.dtype)
    y = launch_ffn("expert_ffn", x, None, w1, w3, w2, out_dtype, act, 1, T)
    expert_ffn.launches += 1
    return y.reshape(E, T, M)


expert_ffn.launches = 0
