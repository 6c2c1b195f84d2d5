"""Flash attention forward (counterpart of
``repro/kernels/flash_attention.py``): a CUDA kernel
(``csrc/flash_attention.cu``) for tensors on the card, its plain PyTorch
version for tensors on the CPU.

``flash_attention.launches`` counts the CUDA kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, meta
from repro_torch.kernels.ref import flash_attention_ref

#: head dims the kernel is compiled for (qwen3: 128, gpt2-moe: 64)
HEAD_DIMS = (64, 128)

_P, _I = ctypes.c_void_p, ctypes.c_int
_C_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I,
           _I, _P)


@functools.cache
def _c_fn():
    fn = _build.library("flash_attention").repro_flash_attention
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    return fn


def flash_attention_plain(q, k, v, *, causal=True, window=None, scale=None):
    """The plain version on GQA inputs: K/V repeated by ``H // K`` (as the
    JAX registry's oracle wrapper does), then ``flash_attention_ref``."""
    H, K = q.shape[2], k.shape[2]
    if H != K:
        k = torch.repeat_interleave(k, H // K, dim=2)
        v = torch.repeat_interleave(v, H // K, dim=2)
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               scale=scale)


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q (B, Lq, H, hd), k/v (B, Lk, K, "
                         f"hd); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, hd = q.shape
    _, Lk, K, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {K} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not compiled "
                         f"(have {HEAD_DIMS})")
    if Lk == 0:
        raise ValueError("flash_attention: no keys")
    if window is not None and int(window) <= 0:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v dtypes differ")
    dev = q.get_device()
    if k.get_device() != dev or v.get_device() != dev:
        raise ValueError("flash_attention: q, k and v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    _build.check_aligned("flash_attention", {}, {"q": q, "k": k, "v": v})


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B, Lq, H, hd); k, v: (B, Lk, K, hd) with H % K == 0, one dtype
    (float32 or bfloat16), hd 64 or 128.  Returns (B, Lq, H, hd) in q's
    dtype.  CPU tensors take the plain version; CUDA tensors take the
    kernel, or raise if it cannot take them."""
    if q.is_meta:
        return meta.flash_attention(q, k, v, causal, window)
    if not _build.on_card(q, "flash_attention"):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    _check(q, k, v, window)
    B, Lq, H, hd = q.shape
    _, Lk, K, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    code = _build.dtype_code(q, "flash_attention")
    out = torch.empty_like(q)
    err = _c_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, Lq, Lk, H, K, hd, float(scale), int(bool(causal)),
                  int(window or 0), code, _build.stream_ptr(q.get_device()))
    _build.check_launch(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
