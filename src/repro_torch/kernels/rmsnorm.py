"""Fused RMSNorm (counterpart of ``repro/kernels/rmsnorm.py``): a CUDA
kernel (``csrc/rmsnorm.cu``) for tensors on the card, its plain PyTorch
version for tensors on the CPU.

``rmsnorm.launches`` counts the CUDA kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_ref

_C_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


@functools.cache
def _c_fn():
    fn = _build.library("rmsnorm").repro_rmsnorm
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    return fn


def rmsnorm(x, scale, *, eps=1e-5):
    """x: (R, D) rows, float32 or bfloat16; scale: (D,) float32.  Returns
    (R, D) in x's dtype.  CPU tensors take the plain version; CUDA tensors
    take the kernel, or raise if it cannot take them."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"rmsnorm: no kernel for device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"rmsnorm: x must be (R, D), got {tuple(x.shape)}")
    R, D = x.shape
    if scale.shape != (D,) or scale.dtype != torch.float32:
        raise ValueError(f"rmsnorm: scale must be float32 ({D},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError("rmsnorm: x and scale on different devices")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    code = _build.dtype_code(x, "rmsnorm")
    out = torch.empty_like(x)
    err = _c_fn()(x.data_ptr(), scale.data_ptr(), out.data_ptr(), R, D,
                  float(eps), code, _build.stream_ptr(x.device))
    _build.check_launch(err, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
