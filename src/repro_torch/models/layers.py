"""Shared layers (counterpart of ``repro/models/layers.py``): functions on
tensors over the JAX package's parameter-dict layout.  Initializers draw
from an explicit ``torch.Generator`` on its own device."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import ACT, scatter_rows_in_order
from repro_torch.kernels.registry import get_op


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


def apply_ffn(p, x, act="silu"):
    actf = dict(ACT, relu=F.relu)[act]
    h = x @ p["w_in"]
    if "b_in" in p:
        h = h + p["b_in"]
    if "w_gate" in p:
        h = actf(x @ p["w_gate"]) * h
    else:
        h = actf(h)
    out = h @ p["w_out"]
    if "b_out" in p:
        out = out + p["b_out"]
    return out


# --- embeddings ---------------------------------------------------------------

def init_embedding(generator, vocab, d_model, dtype=torch.float32):
    t = torch.randn((vocab, d_model), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return {"table": t.mul_(0.02).to(dtype)}


class _EmbedVJP(torch.autograd.Function):
    """``table[ids]`` whose backward sums a row's cotangents in ids order,
    the same bits every run: on the CPU by ``scatter_rows_in_order``
    (JAX's bits; the CPU's accumulating ``index_put_``, autograd's
    default, adds from several threads in no fixed order), on the card by
    the accumulating ``index_put_``, which there sorts the ids stably and
    sums each run of them in order."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1])
        ids = ids.reshape(-1)
        if g.is_cuda:
            out = g.new_zeros((ctx.n_rows, g.shape[-1]))
            return out.index_put_((ids,), g, accumulate=True), None
        return scatter_rows_in_order(g, ids, ctx.n_rows), None


def embed(p, ids):
    return _EmbedVJP.apply(p["table"], ids)


def unembed(p, x):
    return x @ p["table"].T
