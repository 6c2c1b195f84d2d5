"""Shared layers (counterpart of ``repro/models/layers.py``): functions on
tensors over the JAX package's parameter-dict layout.  Initializers draw
from an explicit ``torch.Generator`` on its own device; ``*_specs`` are
the JAX functions, copied (partition specs over the port's mesh).

On a mesh whose MP group has more than one rank the dense FFN is column /
row parallel and the embedding vocab-parallel (Megatron), through a
:class:`~repro_torch.parallel.tensor.TensorParallel` ``tp``: the
parameters are this rank's shards and ``tp`` makes the collectives."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import ACT, scatter_rows_in_order
from repro_torch.kernels.registry import get_op
from repro_torch.parallel.mesh import axis_size
from repro_torch.parallel.sharding import P


def dense_init(generator, shape, fan_in=None, dtype=torch.float32):
    fan_in = fan_in or shape[0]
    t = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return t.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


# --- norms -------------------------------------------------------------------

def init_norm(d, norm_type="rmsnorm", device="cuda"):
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def norm_specs(norm_type="rmsnorm"):
    p = {"scale": P(None)}
    if norm_type == "layernorm":
        p["bias"] = P(None)
    return p


def apply_norm(p, x, eps=1e-5, kernel=None):
    """LayerNorm (bias present) stays inline; RMSNorm goes through the
    ``rmsnorm`` op, so a CUDA tensor runs the CUDA kernel."""
    if "bias" in p:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
        return out.to(x.dtype)
    op = get_op("rmsnorm", cfg=kernel, eps=eps)
    return op(x.reshape(-1, x.shape[-1]).contiguous(),
              p["scale"]).reshape(x.shape)


# --- rotary embeddings --------------------------------------------------------

def rope_freqs(head_dim, theta=1e4, device="cuda"):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta=1e4):
    """x: (..., L, H, hd); positions: broadcastable to (..., L)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                      # (hd/2,)
    ang = positions[..., None].float() * freqs                   # (..., L, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length, d, device="cuda"):
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((length, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# --- dense FFN ---------------------------------------------------------------

def init_ffn(generator, d_model, d_ff, glu=True, bias=False,
             dtype=torch.float32):
    dev = generator.device
    p = {"w_in": dense_init(generator, (d_model, d_ff), dtype=dtype),
         "w_out": dense_init(generator, (d_ff, d_model), fan_in=d_ff,
                             dtype=dtype)}
    if glu:
        p["w_gate"] = dense_init(generator, (d_model, d_ff), dtype=dtype)
    if bias:
        p["b_in"] = torch.zeros((d_ff,), dtype=dtype, device=dev)
        p["b_out"] = torch.zeros((d_model,), dtype=dtype, device=dev)
    return p


def ffn_specs(mesh, mp_axes, d_ff, glu=True, bias=False):
    ff_ax = tuple(mp_axes) if mp_axes and \
        d_ff % axis_size(mesh, mp_axes) == 0 else None
    p = {"w_in": P(None, ff_ax), "w_out": P(ff_ax, None)}
    if glu:
        p["w_gate"] = P(None, ff_ax)
    if bias:
        p["b_in"] = P(ff_ax)
        p["b_out"] = P(None)
    return p


def _ffn_out(p, x, act):
    """The FFN up to ``w_out``'s product, before ``b_out``."""
    actf = dict(ACT, relu=F.relu)[act]
    h = x @ p["w_in"]
    if "b_in" in p:
        h = h + p["b_in"]
    if "w_gate" in p:
        h = actf(x @ p["w_gate"]) * h
    else:
        h = actf(h)
    return h @ p["w_out"]


def apply_ffn(p, x, act="silu", tp=None):
    """The FFN on ``x``.  With ``tp`` it is column / row parallel: ``p``
    holds this rank's columns of ``w_in`` / ``w_gate`` (and ``b_in``) and
    rows of ``w_out``, ``x`` is the residual stream (``tp.enter`` /
    ``tp.leave`` around the sharded products) and ``b_out`` is added once,
    after the reduction."""
    if tp is None:
        out = _ffn_out(p, x, act)
    else:
        out = tp.leave(_ffn_out(p, tp.enter(x), act))
    if "b_out" in p:
        out = out + p["b_out"]
    return out


# --- embeddings ---------------------------------------------------------------

def init_embedding(generator, vocab, d_model, dtype=torch.float32):
    t = torch.randn((vocab, d_model), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return {"table": t.mul_(0.02).to(dtype)}


def embedding_specs(mesh, mp_axes, vocab):
    v_ax = tuple(mp_axes) if mp_axes and \
        vocab % axis_size(mesh, mp_axes) == 0 else None
    return {"table": P(v_ax, None)}


class _EmbedVJP(torch.autograd.Function):
    """``table[ids]`` whose backward sums a row's cotangents in ids order,
    the same bits every run: on the CPU by ``scatter_rows_in_order``
    (JAX's bits; the CPU's accumulating ``index_put_``, autograd's
    default, adds from several threads in no fixed order), on the card by
    the accumulating ``index_put_``, which there sorts the ids stably and
    sums each run of them in order; on the meta device (the dry run) the
    same ``index_put_``, for its shape.  With ``masked`` an id equal to the
    table's row count (a token of another rank's vocabulary block) reads a
    zero row and adds nothing to the gradient: its cotangent goes to a
    discarded row, so the other rows keep their summation order."""

    @staticmethod
    def forward(ctx, table, ids, masked=False):
        ctx.save_for_backward(ids)
        ctx.n_rows, ctx.masked = table.shape[0], masked
        if not masked:
            return table[ids]
        own = ids < ctx.n_rows
        rows = table[torch.clamp(ids, max=ctx.n_rows - 1)]
        return torch.where(own[..., None], rows, torch.zeros_like(rows))

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1])
        ids = ids.reshape(-1)
        if g.is_cuda or g.is_meta:
            out = g.new_zeros((ctx.n_rows + int(ctx.masked), g.shape[-1]))
            out.index_put_((ids,), g, accumulate=True)
            return out[:ctx.n_rows], None, None
        return scatter_rows_in_order(g, ids, ctx.n_rows), None, None


def embed(p, ids, tp=None):
    """``table[ids]``.  With ``tp`` it is vocab-parallel: ``p["table"]``
    holds this rank's block of rows, ids outside it read zeros, and the
    partial rows are summed over MP into the residual stream's layout
    (``tp.leave``)."""
    if tp is None:
        return _EmbedVJP.apply(p["table"], ids)
    n = p["table"].shape[0]
    local = ids.long() - tp.index * n
    local = torch.where((local >= 0) & (local < n), local,
                        torch.full_like(local, n))
    return tp.leave(_EmbedVJP.apply(p["table"], local, True))


def unembed(p, x):
    return x @ p["table"].T
