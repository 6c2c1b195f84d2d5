"""AdamW with global-norm clipping and a cosine LR schedule (counterpart of
``repro/optim/adamw.py``, with the guard rails' ``lr_scale`` and
``finite`` skip).  On a mesh each rank updates its own shards; the norm is
the global parameters' (``global_norm(..., specs=, mesh=)``), so the clip
scale is the same on every rank.

ZeRO-1 (``opt_state_specs(..., zero1=True)``, JAX's rule): each moment
is its parameter's shard further split over the pure data-parallel axes
along one dim.  A rank then updates only the slice of each parameter that
its moments cover, from the synced gradient, and all-gathers the
parameter over those axes, so the parameters are the unsharded-moment
step's.  The dry run (``launch/dryrun.py``) picks the axes as JAX's does.

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


def adamw_init(params, zero=None, mesh=None) -> dict:
    """Zero f32 moments shaped like ``params`` and an int32 step of 0.
    With ``zero`` (:func:`zero1_dims`, aligned with the leaves) and
    ``mesh``, each moment is this rank's ZeRO-1 slice of its parameter."""
    def zeros(tree, zs):
        if isinstance(tree, dict):
            return {k: zeros(v, zs) for k, v in tree.items()}
        shape, z = list(tree.shape), next(zs)
        if z is not None:
            shape[z[0]] //= mesh.group(z[1]).size
        return torch.zeros(shape, dtype=torch.float32, device=tree.device)

    flat = leaves(params)
    zero = zero or [None] * len(flat)
    return {"mu": zeros(params, iter(zero)), "nu": zeros(params, iter(zero)),
            "step": torch.zeros((), dtype=torch.int32,
                                device=flat[0].device)}


def _map_specs(fn, specs, shapes):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, shapes[k]) for k, v in specs.items()}
    return fn(specs, shapes)


def opt_state_specs(param_specs, mesh=None, dp_axes=(), zero1=False,
                    params_shape=None) -> dict:
    """The AdamW state's specs on a mesh (JAX's ``opt_state_specs``):
    each moment as its parameter, the step replicated.  With ``zero1``,
    ``dp_axes``, ``mesh`` and ``params_shape`` (the parameters, or
    anything with their ``shape``s, in ``param_specs``'s tree) ZeRO-1
    also splits each moment over ``dp_axes``, along the largest dim its
    spec leaves whole that the axes' size divides (ties to the lowest
    dim, as JAX's loop takes them); a leaf with none keeps its
    parameter's spec."""
    from repro_torch.parallel.mesh import axis_size
    from repro_torch.parallel.sharding import P

    def z1(spec, shaped):
        if not zero1 or not dp_axes or mesh is None:
            return spec
        shape = tuple(shaped.shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        n = axis_size(mesh, dp_axes)
        best = None
        for i, (d, sp) in enumerate(zip(shape, parts)):
            if sp is None and d % max(n, 1) == 0 and d >= n:
                if best is None or d > shape[best]:
                    best = i
        if best is None:
            return spec
        parts[best] = tuple(dp_axes)
        return P(*parts)

    mom = param_specs
    if zero1 and params_shape is not None:
        mom = _map_specs(z1, param_specs, params_shape)
    return {"mu": mom, "nu": mom, "step": P()}


def zero1_dims(specs, mom_specs) -> list:
    """Per leaf (two lists aligned with the leaves: the parameters' and
    the moments' specs), the ``(dim, axes)`` that the moment's spec
    splits and the parameter's leaves whole (ZeRO-1), else None."""
    out = []
    for ps, ms in zip(specs, mom_specs):
        z = None
        for d, e in enumerate(ms):
            if e is not None and (d >= len(ps) or ps[d] is None):
                z = (d, (e,) if isinstance(e, str) else tuple(e))
        out.append(z)
    return out


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
                 lr_scale=1.0, finite=None, specs=None, mesh=None,
                 zero=None):
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
    norm the global one (:func:`global_norm`).  ``zero`` (:func:`zero1_dims`
    of the moments' specs) marks the ZeRO-1 moments: such a leaf updates
    the slice its moments cover and is all-gathered over their axes.

    On the meta device (the dry run) the skip's flag has no value to
    read: the update runs, costs only, and the decision is a real run's."""
    from repro_torch.parallel import comm
    flat_p, flat_g = leaves(params), list(grads)
    flat_mu, flat_nu = leaves(state["mu"]), leaves(state["nu"])
    if decay_mask is None:
        decay_mask = [p.dim() >= 2 for p in flat_p]
    if finite is not None:
        gnorm = global_norm(flat_g, specs, mesh)
        ok = torch.isfinite(gnorm) & torch.as_tensor(finite,
                                                     device=gnorm.device)
        if not ok.is_meta and not ok.item():
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
    for p, g, mu, nu, wd, z in zip(flat_p, flat_g, flat_mu, flat_nu,
                                   decay_mask, zero or [None] * len(flat_p)):
        whole = p
        if z is not None:
            grp = mesh.group(z[1])
            n = p.shape[z[0]] // grp.size
            p = p.narrow(z[0], grp.index * n, n).contiguous()
            g = g.narrow(z[0], grp.index * n, n)
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
        if z is not None:
            whole.copy_(comm.all_gather(p, grp, z[0]))
    om = {"grad_norm": gnorm, "lr": lr}
    if finite is not None:
        om["finite"] = ok
    return om
