"""Kernel seam of the port (counterpart of ``repro/kernels/registry.py``).

``get_op(name, cfg=, **static)`` returns the op ``name`` with its static
parameters bound.  The backend follows the tensor: a CUDA tensor launches
the hand-written CUDA kernel (or the wrapper raises), a CPU tensor runs the
plain PyTorch version.  There is no backend override, so a CUDA tensor can
never fall back to the plain version.

Ops: ``rmsnorm`` (static ``eps``), ``expert_ffn_grouped`` (static ``cap``,
``act``, ``wire``) and ``flash_attention`` (static ``causal``, ``window``,
``scale``).  The other four TPU kernels of the JAX package come with later
slices.

Gradients: the JAX package has no backward Pallas kernel.  It
differentiates these three ops by recomputing through their jnp oracles
(``_with_ref_vjp``, ``_grouped_fused_vjp``), and the port does the same: a
call that needs a gradient goes through :class:`_RecomputeVJP`, whose
forward runs the op (kernel or plain version, by device) and saves only the
raw inputs, and whose backward re-runs the plain version on them and
differentiates that.  A call that needs no gradient calls the op directly.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.kernels.expert_ffn_grouped import expert_ffn_grouped
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.ref import expert_ffn_grouped_ref, rmsnorm_ref
from repro_torch.kernels.rmsnorm import rmsnorm


@dataclass(frozen=True)
class KernelConfig:
    """The JAX package's kernel config, field for field, so that model
    configs carry over unchanged.  In the port ``backend`` must stay
    ``"auto"`` (the device decides) and ``interpret`` unset; the tile sizes
    are accepted for parity, while the CUDA kernels' tiles are compile-time
    constants in ``csrc/``."""

    backend: str = "auto"
    interpret: Optional[bool] = None
    block_t: int = 128
    block_f: int = 256
    block_s: int = 256
    block_r: int = 256
    block_q: int = 128
    block_k: int = 128


DEFAULT = KernelConfig()

#: op name -> the forward (kernel on CUDA, plain version on the CPU)
_OPS = {"rmsnorm": rmsnorm, "expert_ffn_grouped": expert_ffn_grouped,
        "flash_attention": flash_attention}
#: op name -> the plain version its backward differentiates
_PLAIN = {"rmsnorm": rmsnorm_ref,
          "expert_ffn_grouped": expert_ffn_grouped_ref,
          "flash_attention": flash_attention_plain}


class _RecomputeVJP(torch.autograd.Function):
    """``fwd(*args)`` forward; backward recomputes ``plain(*args)`` and
    returns its gradients (None for integer and constant inputs, such as
    the grouped op's ``flat_idx``)."""

    @staticmethod
    def forward(ctx, fwd, plain, *args):
        ctx.plain = plain
        ctx.save_for_backward(*args)
        return fwd(*args)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        want = [i for i in range(len(args)) if ctx.needs_input_grad[i + 2]]
        with torch.enable_grad():
            inputs = [a.detach().requires_grad_(True) if i in want else a
                      for i, a in enumerate(args)]
            out = ctx.plain(*inputs)
            grads = torch.autograd.grad(out, [inputs[i] for i in want], g,
                                        allow_unused=True)
        res = [None] * len(args)
        for i, gi in zip(want, grads):
            res[i] = gi
        return (None, None, *res)


def list_ops() -> tuple:
    return tuple(sorted(_OPS))


def _call(name: str, static: dict, *args):
    fwd = functools.partial(_OPS[name], **static)
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return _RecomputeVJP.apply(
            fwd, functools.partial(_PLAIN[name], **static), *args)
    return fwd(*args)


def get_op(name: str, *, cfg: Optional[KernelConfig] = None,
           **static) -> Callable:
    """The op ``name`` with ``static`` keyword parameters bound."""
    cfg = cfg or DEFAULT
    if cfg.backend != "auto" or cfg.interpret is not None:
        raise ValueError(
            f"KernelConfig(backend={cfg.backend!r}, interpret="
            f"{cfg.interpret!r}): the port picks the backend from the "
            "tensor's device; leave both at their defaults")
    if name not in _OPS:
        raise KeyError(f"no kernel op {name!r} in this slice of the port "
                       f"(have {list_ops()})")
    return functools.partial(_call, name, static)
