"""Kernel seam of the port (counterpart of ``repro/kernels/registry.py``).

``get_op(name, cfg=, **static)`` returns the op ``name`` with its static
parameters bound.  The backend follows the tensor: a CUDA tensor launches
the hand-written CUDA kernel (or the wrapper raises), a CPU tensor runs the
plain PyTorch version.  There is no backend override, so a CUDA tensor can
never fall back to the plain version.

Ops: ``rmsnorm`` (static ``eps``), ``expert_ffn_grouped`` (static ``cap``,
``act``, ``wire``), ``flash_attention`` (static ``causal``, ``window``,
``scale``), ``expert_ffn`` and ``expert_ffn_ragged`` (static ``act``),
``moe_dispatch`` (static ``n_slots``) and ``moe_combine``: every TPU kernel
of the JAX package.

Gradients: the JAX package has no backward Pallas kernel, and the port
differentiates each op as it does.  ``moe_dispatch``, ``moe_combine`` and
``expert_ffn_ragged`` have closed-form transposes (JAX's
``_dispatch_analytic_vjp``, ``_combine_analytic_vjp`` and
``_ragged_analytic_vjp``), written in plain torch in
``autograd.Function``s that save only what JAX's residuals hold; combine's
buffer cotangent is a ``moe_dispatch`` (the kernel on the card), which
sums repeated slots in JAX's order with no atomics.  The
others recompute through their plain versions (``_with_ref_vjp``,
``_grouped_fused_vjp``): a call that needs a gradient goes through
:class:`_RecomputeVJP`, whose forward runs the op (kernel or plain
version, by device) and saves only the raw inputs, and whose backward
re-runs the plain version on them and differentiates that.  A call that
needs no gradient calls the op directly.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.kernels import meta, ref
from repro_torch.kernels.expert_ffn import expert_ffn
from repro_torch.kernels.expert_ffn_grouped import (expert_ffn_grouped,
                                                    expert_ffn_ragged)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.moe_dispatch import moe_combine, moe_dispatch
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
        "flash_attention": flash_attention, "expert_ffn": expert_ffn,
        "expert_ffn_ragged": expert_ffn_ragged,
        "moe_dispatch": moe_dispatch, "moe_combine": moe_combine}
#: op name -> its plain version (what a recompute backward differentiates,
#: and what a reference run swaps in behind ``get_op``)
PLAIN = {"rmsnorm": ref.rmsnorm_ref,
         "expert_ffn_grouped": ref.expert_ffn_grouped_ref,
         "flash_attention": flash_attention_plain,
         "expert_ffn": ref.expert_ffn_ref,
         "expert_ffn_ragged": ref.expert_ffn_ragged_ref,
         "moe_dispatch": ref.moe_dispatch_ref,
         "moe_combine": ref.moe_combine_ref}
_NAME_OF = {fn: name for name, fn in PLAIN.items()}


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
        if g.is_meta:
            # shapes and costs only (kernels/meta.py)
            p = ctx.plain
            return (None, None, *meta.backward(
                _NAME_OF[p.func], args, p.keywords,
                ctx.needs_input_grad[2:]))
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


class _DispatchVJP(torch.autograd.Function):
    """Dispatch's transpose: the gather of the buffer's cotangent at each
    token's slots, summed over its k choices (the drop sentinel's row is
    zero).  Saves ``flat_idx`` only."""

    @staticmethod
    def forward(ctx, fwd, static, x, flat_idx):
        ctx.save_for_backward(flat_idx)
        return fwd(x, flat_idx)

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        gpad = torch.cat([g, g.new_zeros((1, g.shape[-1]))])
        return None, None, gpad[flat.long()].sum(dim=1), None


class _CombineVJP(torch.autograd.Function):
    """Combine's transpose: a scatter-add of ``w[s, j] * g[s]`` into the
    slots (w.r.t. the buffer), summed in entry order by ``moe_dispatch``
    (the CUDA kernel on the card, the plain version on the CPU: JAX's
    bits, and the same bits every run), and the gathered rows dotted with
    the cotangent (w.r.t. the weights); dropped choices get zero.  Saves
    ``(buf, flat_idx, weights)``."""

    @staticmethod
    def forward(ctx, fwd, static, buf, flat_idx, weights):
        ctx.save_for_backward(buf, flat_idx, weights)
        return fwd(buf, flat_idx, weights)

    @staticmethod
    def backward(ctx, g):
        buf, flat, weights = ctx.saved_tensors
        n_slots, M = buf.shape
        S, k = flat.shape
        kept = flat < n_slots
        idx = flat.long()
        cot_buf = cot_w = None
        if ctx.needs_input_grad[2]:
            # JAX's .at[flat].add(src): a dispatch with k = 1 sums a
            # repeated slot's rows in entry order, with no atomics
            w = torch.where(kept, weights, 0.0).to(buf.dtype)
            src = w[:, :, None] * g[:, None, :].to(buf.dtype)
            cot_buf = moe_dispatch(src.reshape(S * k, M),
                                   flat.reshape(S * k, 1), n_slots)
        if ctx.needs_input_grad[4]:
            vals = buf[idx.clamp(max=n_slots - 1).reshape(-1)]
            cot_w = torch.einsum("sm,skm->sk", g.to(buf.dtype),
                                 vals.reshape(S, k, M))
            cot_w = torch.where(kept, cot_w, 0.0).to(weights.dtype)
        return None, None, cot_buf, None, cot_w


class _RaggedVJP(torch.autograd.Function):
    """The ragged FFN's hand-written transpose (JAX's
    ``_ragged_analytic_vjp``): the two GEMMs transposed in f32, with the
    routed-row mask folded into the cotangent.  Saves the raw inputs."""

    @staticmethod
    def forward(ctx, fwd, static, xb, counts, w1, w3, w2):
        ctx.act = static.get("act", "silu")
        ctx.save_for_backward(xb, counts, w1, w3, w2)
        return fwd(xb, counts, w1, w3, w2)

    @staticmethod
    def backward(ctx, g):
        xb, counts, w1, w3, w2 = ctx.saved_tensors
        E, G, c, M = xb.shape
        mask = torch.arange(c, device=xb.device)[None, None, :] \
            < counts[:, :, None]
        gm = (g * mask[..., None].to(g.dtype)).reshape(E, G * c, M).float()
        xf = xb.reshape(E, G * c, M).float()
        w1f, w2f = w1.float(), w2.float()
        w3f = w3.float() if w3 is not None else None
        with torch.enable_grad():
            h1 = torch.einsum("etm,emf->etf", xf, w1f).requires_grad_(True)
            hs = [h1]
            mid = ref.ACT[ctx.act](h1)
            if w3f is not None:
                h3 = torch.einsum("etm,emf->etf", xf, w3f)
                h3.requires_grad_(True)
                hs.append(h3)
                mid = mid * h3
            d_mid = torch.einsum("etm,efm->etf", gm, w2f)
            d_hs = torch.autograd.grad(mid, hs, d_mid)
        d_w2 = torch.einsum("etf,etm->efm", mid.detach(), gm).to(w2.dtype)
        d_x = torch.einsum("etf,emf->etm", d_hs[0], w1f)
        d_w3 = None
        if w3f is not None:
            d_x = d_x + torch.einsum("etf,emf->etm", d_hs[1], w3f)
            d_w3 = torch.einsum("etm,etf->emf", xf, d_hs[1]).to(w3.dtype)
        d_w1 = torch.einsum("etm,etf->emf", xf, d_hs[0]).to(w1.dtype)
        d_x = d_x.reshape(E, G, c, M).to(xb.dtype)
        return None, None, d_x, None, d_w1, d_w3, d_w2


#: op name -> its closed-form autograd.Function; the others recompute
_CLOSED_FORM = {"moe_dispatch": _DispatchVJP, "moe_combine": _CombineVJP,
                "expert_ffn_ragged": _RaggedVJP}


def list_ops() -> tuple:
    return tuple(sorted(_OPS))


def launches(reset: bool = False) -> dict:
    """Each op's CUDA launches so far (its wrapper's ``launches``); with
    ``reset`` every count is set to 0 first."""
    if reset:
        for fn in _OPS.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in _OPS.items()}


def _call(name: str, static: dict, *args):
    fwd = functools.partial(_OPS[name], **static)
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        if name in _CLOSED_FORM:
            return _CLOSED_FORM[name].apply(fwd, static, *args)
        return _RecomputeVJP.apply(
            fwd, functools.partial(PLAIN[name], **static), *args)
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
