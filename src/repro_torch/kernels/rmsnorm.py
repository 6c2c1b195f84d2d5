"""Fused RMSNorm (counterpart of ``repro/kernels/rmsnorm.py``): a CUDA
kernel (``csrc/rmsnorm.cu``) for tensors on the card, its plain PyTorch
version for tensors on the CPU.

``rmsnorm.launches`` counts the CUDA kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch

from repro_torch.kernels import _build, meta
from repro_torch.kernels.ref import rmsnorm_ref

#: the C entry point's one argument, ``RmsnormArgs`` in ``csrc/rmsnorm.cu``:
#: x, scale, out, stream, rows, d, dtype, eps
_ARGS = struct.Struct("PPPPiiif").pack


@functools.cache
def _c_fns():
    lib = _build.library("rmsnorm")
    fn, path = lib.repro_rmsnorm, lib.repro_rmsnorm_path
    fn.restype = ctypes.c_int       # no argtypes: bytes pass as a pointer
    path.argtypes = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2
                     + (ctypes.POINTER(ctypes.c_int),) * 2)
    path.restype = None
    return fn, path


def rmsnorm(x, scale, *, eps=1e-5):
    """x: (R, D) rows, float32 or bfloat16; scale: (D,) float32.  Returns
    (R, D) in x's dtype.  CPU tensors take the plain version; CUDA tensors
    take the kernel, or raise if it cannot take them."""
    if x.is_meta:
        return meta.rmsnorm(x, scale)
    if not _build.on_card(x, "rmsnorm"):
        return rmsnorm_ref(x, scale, eps)
    if x.dim() != 2:
        raise ValueError(f"rmsnorm: x must be (R, D), got {tuple(x.shape)}")
    R, D = x.shape
    if scale.shape != (D,) or scale.dtype != torch.float32:
        raise ValueError(f"rmsnorm: scale must be float32 ({D},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    dev = x.get_device()
    if scale.get_device() != dev:
        raise ValueError("rmsnorm: x and scale on different devices")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    code = _build.dtype_code(x, "rmsnorm")
    out = torch.empty_like(x)
    err = _c_fns()[0](_ARGS(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                            _build.stream_ptr(dev), R, D, code, eps))
    _build.check_launch(err, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


def kernel_path(x, scale, out):
    """The kernel path that rows of ``x`` (with ``scale`` and output
    ``out``, CUDA tensors) take: (threads per row, 16-byte vectors per
    thread) of the vector path, or None for the scalar path.  Launches
    nothing."""
    tpr, nv = ctypes.c_int(), ctypes.c_int()
    _c_fns()[1](x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.shape[-1],
                _build.dtype_code(x, "rmsnorm"), ctypes.byref(tpr),
                ctypes.byref(nv))
    return (tpr.value, nv.value) if tpr.value else None
