"""AdamW with global-norm clipping and a cosine LR schedule (counterpart of
``repro/optim/adamw.py``, with the guard rails' ``lr_scale`` and
``finite`` skip).  On a mesh each rank updates its own shards; the norm is
the global parameters' (``global_norm(..., specs=, mesh=)``), so the clip
scale is the same on every rank.  ZeRO-1 (sharded moments) is not ported
yet (ROADMAP item 5.2).

Parameters and moments are updated IN PLACE under ``torch.no_grad()``,
where JAX returns new trees: at full width a second copy of the parameters
(12.46 GB for four qwen3-moe-30b-a3b layers in f32) would not fit beside
the gradients and both moments on one 80 GB card.  The step counter, the
bias corrections and the schedule are float32 tensors, as in JAX, so the
arithmetic rounds as it does there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def leaves(tree) -> list:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def cosine_schedule(cfg: AdamWConfig, step):
    """Linear warmup then cosine decay to ``min_lr_frac``; ``step`` is a
    tensor (or int), the result a float32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def adamw_init(params) -> dict:
    """Zero f32 moments shaped like ``params`` and an int32 step of 0."""
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros_like(tree, dtype=torch.float32)

    dev = leaves(params)[0].device
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_specs(param_specs) -> dict:
    """The AdamW state's specs on a mesh (JAX's ``opt_state_specs``
    without ZeRO-1): each moment as its parameter, the step replicated."""
    from repro_torch.parallel.sharding import P
    return {"mu": param_specs, "nu": param_specs, "step": P()}


def global_norm(grads, specs=None, mesh=None):
    """sqrt of the sum of squares of every gradient, in f32.  With
    ``mesh`` and ``specs`` (each leaf's ``PartitionSpec``, aligned with
    ``grads``) the gradients are this rank's shards of the global ones: a
    sharded leaf's squares are summed over the axes that shard it (one
    ``psum`` per distinct axis set), a replicated leaf's counted once, so
    every rank gets the global norm's bits."""
    if mesh is None:
        total = None
        for g in grads:
            s = torch.sum(torch.square(g.float()))
            total = s if total is None else total + s
        return torch.sqrt(total)
    from repro_torch.parallel import comm
    from repro_torch.parallel.sharding import mentioned
    parts = {}
    for g, spec in zip(grads, specs):
        axes = tuple(a for a in mesh.axis_names if a in mentioned(spec))
        s = torch.sum(torch.square(g.float()))
        parts[axes] = s if axes not in parts else parts[axes] + s
    total = None
    for axes, s in parts.items():
        if axes:
            s = comm.psum(s, mesh.group(axes))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, decay_mask=None,
                 lr_scale=1.0, finite=None, specs=None, mesh=None):
    """One AdamW step, in place.  ``grads`` is a sequence aligned with
    ``leaves(params)``; ``decay_mask`` a list of bools, by default True for
    leaves with ``dim() >= 2`` -- which, with stacked runs, includes every
    per-layer (n, D) norm scale and bias but not ``final_norm`` (D,),
    exactly as in JAX.  Returns the metrics ``grad_norm`` and ``lr``.

    ``lr_scale`` (a float) multiplies the scheduled LR (the guard rails'
    backoff); 1.0 runs no multiply.  ``finite`` (a bool or a bool tensor,
    e.g. ``isfinite(loss)``) opts into the guard rails' skip-step: it is
    AND-ed with ``isfinite(grad_norm)`` and read on the host (one sync);
    when false the update returns before touching any leaf, so
    parameters, both moments and the step counter stay bitwise as they
    were.  JAX selects ``where(finite, new, old)`` per leaf instead; in
    place that would keep two more leaf-sized copies alive.  The combined
    flag comes back as ``"finite"``.  With ``finite=None`` and
    ``lr_scale=1.0`` this is the plain update, op for op.  ``specs`` and
    ``mesh`` (a list aligned with the leaves, and the mesh) make the clip
    norm the global one (:func:`global_norm`)."""
    flat_p, flat_g = leaves(params), list(grads)
    flat_mu, flat_nu = leaves(state["mu"]), leaves(state["nu"])
    if decay_mask is None:
        decay_mask = [p.dim() >= 2 for p in flat_p]
    if finite is not None:
        gnorm = global_norm(flat_g, specs, mesh)
        ok = torch.isfinite(gnorm) & torch.as_tensor(finite,
                                                     device=gnorm.device)
        if not ok.item():
            lr = cosine_schedule(cfg, state["step"] + 1)
            if lr_scale != 1.0:
                lr = lr * lr_scale
            return {"grad_norm": gnorm, "lr": lr, "finite": ok}
    state["step"] += 1
    step = state["step"]
    lr = cosine_schedule(cfg, step)
    if lr_scale != 1.0:
        lr = lr * lr_scale
    if finite is None:
        gnorm = global_norm(flat_g, specs, mesh)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1c = 1 - torch.pow(cfg.beta1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.beta2, step.to(torch.float32))
    # at most two leaf-sized temporaries are alive at once: the largest
    # leaf (four layers' stacked w1, 3.2 GB) sets the step's peak memory
    for p, g, mu, nu, wd in zip(flat_p, flat_g, flat_mu, flat_nu,
                                decay_mask):
        g = g.float() * scale
        mu.mul_(cfg.beta1).add_(g, alpha=1 - cfg.beta1)
        nu.mul_(cfg.beta2).addcmul_(g, g, value=1 - cfg.beta2)
        del g
        delta = (mu / b1c).div_(torch.div(nu, b2c).sqrt_().add_(cfg.eps))
        if wd:
            delta.add_(p.float(), alpha=cfg.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_(p.float().sub_(delta.mul_(lr)))
    om = {"grad_norm": gnorm, "lr": lr}
    if finite is not None:
        om["finite"] = ok
    return om
