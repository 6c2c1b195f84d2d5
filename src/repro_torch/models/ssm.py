"""State-space and recurrent blocks (counterpart of ``repro/models/ssm.py``):
the Mamba-style selective SSM of Hymba's parallel heads, and xLSTM's
mLSTM and sLSTM cells.

JAX runs each recurrence as plain array code (no Pallas kernel), so the
port's are plain PyTorch, in JAX's order of operations:

* Mamba trains over chunks of ``cfg.chunk`` tokens (halved until they
  divide L), the state carried from chunk to chunk.  Within a chunk the
  selective scan is JAX's ``lax.associative_scan``, ported as the same
  odd/even recursion (:func:`associative_scan`): the same combines on
  the same slices, so the same values.  A sequential loop over the chunk
  would give other roundings and a launch per token.
* mLSTM trains chunkwise (stabilized matrix memory and normalizer), the
  carry ``(C, n, m)`` from chunk to chunk; decode is one chunk of one
  token, as in JAX.
* sLSTM is a loop over time steps in both directions, as JAX's
  ``lax.scan`` is.

JAX's ``lax.scan`` over chunks compiles to one loop on the device; in
eager PyTorch every operation is a launch from the host, so the chunk
loops are split: what reads no carry (Mamba's in-chunk scans; mLSTM's
decays, running maximum, scores and state increments) runs for every
chunk at once, and only the carries step from chunk to chunk, through
the same elementwise operations as JAX's on the same values.

Where a ``maximum`` or the chunk's running maximum meets a tie, the
gradient splits as JAX's does: ``torch.maximum`` halves it between equal
operands as ``lax.max`` does, and the running maximum is the associative
scan of ``torch.maximum`` (:func:`cummax`): JAX differentiates
``lax.cummax`` through that scan, where ``torch.cummax`` would send a
tie's whole gradient to one index.  ``|x|`` takes JAX's gradient of +1
at 0 (:func:`_abs`).

Decode carries the recurrent state (O(1) per token): ``(conv_buf, h)``
for Mamba, ``(C, n, m)`` for mLSTM, ``(c, n, h, m)`` for sLSTM, JAX's
tuples.  Initializers draw from an explicit ``torch.Generator`` with
JAX's distributions and constants; ``*_specs`` are the JAX functions,
copied.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.parallel.mesh import axis_size
from repro_torch.parallel.sharding import P


# --- the scans ----------------------------------------------------------------

def _take(t, dim, sl):
    return t[(slice(None),) * dim + (sl,)]


def _interleave(a, b, dim):
    """``a`` at the even and ``b`` at the odd positions along ``dim``
    (``a`` as long as ``b`` or one longer), as JAX's ``_interleave``."""
    n = b.shape[dim]
    pairs = torch.stack([_take(a, dim, slice(0, n)), b], dim=dim + 1)
    out = pairs.flatten(dim, dim + 1)
    if a.shape[dim] > n:
        out = torch.cat([out, _take(a, dim, slice(n, None))], dim=dim)
    return out


def associative_scan(fn, elems, dim):
    """``lax.associative_scan(fn, elems, axis=dim)`` for a tuple of
    tensors: JAX's odd/even recursion (combine adjacent pairs, scan the
    halves, combine the odd results with the even inputs, interleave)."""
    def scan(elems):
        n = elems[0].shape[dim]
        if n < 2:
            return elems
        reduced = fn(tuple(_take(e, dim, slice(0, -1, 2)) for e in elems),
                     tuple(_take(e, dim, slice(1, None, 2)) for e in elems))
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn(tuple(_take(o, dim, slice(0, -1)) for o in odd),
                      tuple(_take(e, dim, slice(2, None, 2)) for e in elems))
        else:
            even = fn(odd,
                      tuple(_take(e, dim, slice(2, None, 2)) for e in elems))
        even = tuple(torch.cat([_take(e, dim, slice(0, 1)), r], dim=dim)
                     for e, r in zip(elems, even))
        return tuple(_interleave(a, b, dim) for a, b in zip(even, odd))
    return scan(tuple(elems))


def cummax(x, dim):
    """The running maximum along ``dim``: ``lax.cummax``'s values, and the
    gradient JAX takes through ``associative_scan(lax.max)``."""
    return associative_scan(lambda l, r: (torch.maximum(l[0], r[0]),),
                            (x,), dim)[0]


def _abs(x):
    """``|x|`` with JAX's gradient (+1 at 0, where ``torch.abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


# =============================== Mamba ========================================

@dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    chunk: int = 128


def init_mamba(generator, cfg: MambaConfig, dtype=torch.float32):
    dev = generator.device
    Di, N = cfg.d_inner, cfg.d_state
    p = {"in_proj": dense_init(generator, (cfg.d_model, 2 * Di),
                               dtype=dtype)}
    p["conv_w"] = torch.randn((cfg.d_conv, Di), generator=generator,
                              device=dev).mul_(0.1).to(dtype)
    p["conv_b"] = torch.zeros((Di,), dtype=dtype, device=dev)
    p["w_bc"] = dense_init(generator, (Di, 2 * N), dtype=dtype)
    p["w_dt"] = dense_init(generator, (Di, Di), dtype=dtype) * 0.1
    # the inverse softplus of a log-uniform dt in [1e-3, 1e-1]
    u = torch.rand((Di,), generator=generator, device=dev)
    lo, hi = math.log(1e-3), math.log(1e-1)
    p["b_dt"] = torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u)))
    # log(1..N) in f32 on the host: numpy's rounding is XLA's for N <= 16
    # (every config's d_state), where torch's log differs at 7 by an ulp
    a_log = torch.from_numpy(np.log(np.arange(1, N + 1, dtype=np.float32)))
    p["a_log"] = a_log.to(dev).expand(Di, N).clone()
    p["d_skip"] = torch.ones((Di,), dtype=torch.float32, device=dev)
    p["out_proj"] = dense_init(generator, (Di, cfg.d_model), fan_in=Di,
                               dtype=dtype)
    return p


def mamba_specs(mesh, mp_axes, cfg: MambaConfig):
    """The JAX function, copied."""
    n = axis_size(mesh, mp_axes) if mp_axes else 1
    di_ax = tuple(mp_axes) if mp_axes and cfg.d_inner % n == 0 else None
    return {
        "in_proj": P(None, di_ax), "conv_w": P(None, di_ax),
        "conv_b": P(di_ax), "w_bc": P(di_ax, None), "w_dt": P(None, di_ax),
        "b_dt": P(di_ax), "a_log": P(di_ax, None), "d_skip": P(di_ax),
        "out_proj": P(di_ax, None),
    }


def _mamba_comb(l, r):
    return (l[0] * r[0], r[0] * l[1] + r[1])


def _by_chunk(t, chunk):
    """(B, L, ...) as (B, L / chunk, chunk, ...)."""
    return t.reshape(t.shape[0], t.shape[1] // chunk, chunk, *t.shape[2:])


def _mamba_chunks(h0, xs, chunk):
    """JAX's ``_mamba_chunk`` over every chunk of ``chunk`` tokens, the
    state carried from chunk to chunk from ``h0`` (B, Di, N).  The
    in-chunk scans read no carry, so they run for all chunks at once;
    then the carry steps from chunk to chunk (JAX's last row of each
    chunk's ``h = pA h0 + pH``), and each chunk's ``h`` is JAX's on the
    same values.  ``xs``: dict of (B, L, Di[/N]).  Returns y (B, L, Di)."""
    B, L, Di = xs["dt"].shape
    dt, Bm, Cm, xin = (_by_chunk(xs[k], chunk) for k in ("dt", "B", "C",
                                                          "x"))
    a = -torch.exp(xs["a_log"])                                 # (Di, N)
    dA = torch.exp(dt[..., None] * a)                      # (B,nc,c,Di,N)
    dBx = (dt * xin)[..., None] * Bm[:, :, :, None, :]     # (B,nc,c,Di,N)
    # h_t = dA_t h_{t-1} + dBx_t over each chunk
    pA, pH = associative_scan(_mamba_comb, (dA, dBx), 2)
    h, h0s = h0, []
    for last_a, last_h in zip(pA[:, :, -1].unbind(1),
                              pH[:, :, -1].unbind(1)):
        h0s.append(h)
        h = last_a * h + last_h
    h = pA * torch.stack(h0s, 1)[:, :, None] + pH           # (B,nc,c,Di,N)
    # an f32 state meets a bf16 model's C: JAX's einsum promotes to f32
    return torch.einsum("bkcdn,bkcn->bkcd", h, Cm.to(h.dtype)).reshape(
        B, L, Di)


def mamba_split(cfg: MambaConfig, n_mp: int) -> bool:
    """Whether the cell runs on its shard over ``n_mp`` MP ranks:
    ``mamba_specs`` shards its channels where ``d_inner`` divides, and
    replicates every leaf otherwise."""
    return n_mp > 1 and cfg.d_inner % n_mp == 0


def apply_mamba(p, cfg: MambaConfig, x, state=None, tp=None):
    """x: (B, L, D).  ``state=None``: training, returns y; ``state=(conv_buf,
    h)``: one-token decode (L == 1), returns (y, state).

    With ``tp`` (``parallel.tensor``; :func:`mamba_split`) ``p`` holds
    this rank's shards, ``x`` is replicated over MP, the state holds this
    rank's channels, and y is this rank's row-parallel part (the caller
    sums it over MP).  ``in_proj``'s columns are a block of ``[x | z]``,
    exchanged into this rank's channels of each; ``w_dt`` reads every
    channel (the conv output gathered over MP); ``w_bc``'s rows give a
    partial ``B``/``C``, summed over MP both ways (each rank's channels
    give part of its cotangent); the scan runs this rank's channels."""
    from repro_torch.parallel.tensor import (all_reduce_mp, exchange_columns,
                                             gather_features)
    B, L, D = x.shape
    N, C = cfg.d_state, cfg.d_conv
    xz = x @ p["in_proj"]
    if tp is not None:
        xz = exchange_columns(xz, tp.grp)
    xin, z = torch.chunk(xz, 2, dim=-1)                   # (B, L, Di[/n])
    Di = xin.shape[-1]

    def gates(conv):
        """dt and (B, C) of the conv output: JAX's two products."""
        dt = F.softplus((conv if tp is None else gather_features(
            conv, tp.grp)) @ p["w_dt"] + p["b_dt"])
        bc = conv @ p["w_bc"]
        if tp is not None:
            bc = all_reduce_mp(bc, tp.grp)
        return (dt, *torch.chunk(bc, 2, dim=-1))

    if state is None:
        pad = F.pad(xin, (0, 0, C - 1, 0))
        conv = sum(pad[:, i:i + L] * p["conv_w"][i] for i in range(C))
        conv = F.silu(conv + p["conv_b"])
        dt, Bm, Cm = gates(conv)                      # Bm, Cm: (B, L, N)
        chunk = min(cfg.chunk, L)
        while L % chunk:
            chunk //= 2
        h0 = torch.zeros((B, Di, N), dtype=torch.float32, device=x.device)
        y = _mamba_chunks(h0, {"dt": dt, "B": Bm, "C": Cm, "x": conv,
                               "a_log": p["a_log"]}, chunk)
        y = y + conv * p["d_skip"]
        return (y * F.silu(z)).to(x.dtype) @ p["out_proj"]

    # ---- decode: one step ----
    conv_buf, h = state                                  # (B,C,Di), (B,Di,N)
    conv_buf = torch.cat([conv_buf[:, 1:], xin], dim=1)
    conv = F.silu(torch.einsum("bcd,cd->bd", conv_buf, p["conv_w"])
                  + p["conv_b"])
    dt, Bm, Cm = gates(conv)                                      # (B, Di)
    a = -torch.exp(p["a_log"])
    dA = torch.exp(dt[..., None] * a)
    h = dA * h + (dt * conv)[..., None] * Bm[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cm.to(h.dtype)) + conv * p["d_skip"]
    y = (y * F.silu(z[:, 0])).to(x.dtype) @ p["out_proj"]
    return y[:, None], (conv_buf, h)


def init_mamba_state(cfg: MambaConfig, batch, dtype=torch.float32,
                     device="cuda", shards: int = 1):
    """``(conv_buf, h)`` of zeros; ``shards``: this rank's ``d_inner /
    shards`` channels of a split cell."""
    Di = cfg.d_inner // shards
    return (torch.zeros((batch, cfg.d_conv, Di), dtype=dtype,
                        device=device),
            torch.zeros((batch, Di, cfg.d_state),
                        dtype=torch.float32, device=device))


# =============================== mLSTM ========================================

@dataclass(frozen=True)
class MLSTMConfig:
    d_model: int
    n_heads: int
    proj_factor: float = 2.0
    chunk: int = 64

    @property
    def d_inner(self):
        return int(self.d_model * self.proj_factor)

    @property
    def head_dim(self):
        return self.d_inner // self.n_heads


def init_mlstm(generator, cfg: MLSTMConfig, dtype=torch.float32):
    dev = generator.device
    D, Di, H = cfg.d_model, cfg.d_inner, cfg.n_heads
    return {
        "up_proj": dense_init(generator, (D, 2 * Di), dtype=dtype),
        "wq": dense_init(generator, (Di, Di), dtype=dtype),
        "wk": dense_init(generator, (Di, Di), dtype=dtype),
        "wv": dense_init(generator, (Di, Di), dtype=dtype),
        "w_if": dense_init(generator, (Di, 2 * H), dtype=dtype) * 0.1,
        "b_i": torch.full((H,), -3.0, dtype=torch.float32, device=dev),
        "b_f": torch.full((H,), 3.0, dtype=torch.float32, device=dev),
        "down_proj": dense_init(generator, (Di, D), fan_in=Di, dtype=dtype),
    }


def mlstm_specs(mesh, mp_axes, cfg: MLSTMConfig):
    """The JAX function, copied."""
    n = axis_size(mesh, mp_axes) if mp_axes else 1
    ax = tuple(mp_axes) if mp_axes and cfg.d_inner % n == 0 else None
    return {"up_proj": P(None, ax), "wq": P(None, ax), "wk": P(None, ax),
            "wv": P(None, ax), "w_if": P(None, None), "b_i": P(None),
            "b_f": P(None), "down_proj": P(ax, None)}


def _mlstm_chunks(carry, qkvif, chunk):
    """JAX's ``_mlstm_chunk`` (stabilized chunkwise mLSTM: matrix memory
    and normalizer) over every chunk of ``chunk`` tokens, the carry from
    chunk to chunk.  What reads no carry (the cumulative log forget gate,
    the running maximum, the masked decays, the scores and the state
    increments) runs for all chunks at once; the carry then steps from
    chunk to chunk: the stabilizer ``m`` (JAX's last row of ``m_step``),
    then ``C`` and ``n`` (JAX's update); each chunk's output is JAX's on
    the same values.

    carry: C (B,H,dk,dv), n (B,H,dk), m (B,H).
    qkvif: q,k,v (B,L,H,hd); logi, logf (B,L,H).
    Returns (carry after the last chunk, y (B,L,H,hd)).
    """
    C, nrm, m = carry
    q, k, v, logi, logf = (_by_chunk(t, chunk) for t in qkvif)
    B, nc, c, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    cf = torch.cumsum(logf, dim=2)                              # (B,nc,c,H)
    # stabilizer: m_t = cum_f_t + max(m_prev, runmax_{j<=t}(logi_j - cum_f_j))
    run = cummax(logi - cf, 2)
    ms = []
    for cf_last, run_last in zip(cf[:, :, -1].unbind(1),
                                 run[:, :, -1].unbind(1)):
        ms.append(m)
        m = cf_last + torch.maximum(m, run_last)
    m_prev = torch.stack(ms, 1)                                 # (B,nc,H)
    m_step = cf + torch.maximum(m_prev[:, :, None], run)
    m_new = m_step[:, :, -1]
    # intra-chunk: masked decayed attention
    dmat = cf[:, :, :, None] - cf[:, :, None, :] + logi[:, :, None]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    dmat = torch.where(mask[:, :, None], dmat, -torch.inf)  # (B,nc,ci,cj,H)
    dmat = torch.exp(dmat - m_step[:, :, :, None])
    s = torch.einsum("bkihd,bkjhd->bkijh", q, k) * scale * dmat
    y_intra = torch.einsum("bkijh,bkjhd->bkihd", s, v)
    n_intra = torch.sum(s, dim=3)
    # each chunk's state increment
    decay_k = torch.exp(cf[:, :, -1:] - cf + logi - m_new[:, :, None])
    kv = torch.einsum("bkchd,bkche,bkch->bkhde", k * scale, v, decay_k)
    ksum = torch.einsum("bkchd,bkch->bkhd", k * scale, decay_k)
    decay_c = torch.exp(m_prev + cf[:, :, -1] - m_new)          # (B,nc,H)
    Cs, ns = [], []
    for dc, kv_k, ks_k in zip(decay_c.unbind(1), kv.unbind(1),
                              ksum.unbind(1)):
        Cs.append(C)
        ns.append(nrm)
        C = C * dc[..., None, None] + kv_k
        nrm = nrm * dc[..., None] + ks_k
    # inter-chunk: the decayed previous state
    decay_q = torch.exp(m_prev[:, :, None] + cf - m_step)       # (B,nc,c,H)
    y_inter = torch.einsum("bkchd,bkhde->bkche", q, torch.stack(Cs, 1)) \
        * decay_q[..., None]
    n_inter = torch.einsum("bkchd,bkhd->bkch", q, torch.stack(ns, 1)) \
        * decay_q
    y = y_inter + y_intra
    denom = torch.maximum(_abs(n_inter + n_intra),
                          torch.exp(-m_step))[..., None]
    y = y / denom
    return (C, nrm, m), y.reshape(B, nc * c, H, hd)


def mlstm_split(cfg: MLSTMConfig, n_mp: int) -> bool:
    """Whether the cell runs on its shard over ``n_mp`` MP ranks
    (``mlstm_specs`` shards its projections where ``d_inner`` divides,
    and replicates every leaf otherwise)."""
    return n_mp > 1 and cfg.d_inner % n_mp == 0


def mlstm_heads_split(cfg: MLSTMConfig, n_mp: int) -> bool:
    """Whether a split cell's ranks each run whole heads (``n_heads``
    divides over MP): its state then holds this rank's heads.  Otherwise
    (the gathered-heads layout) every rank runs every head."""
    return mlstm_split(cfg, n_mp) and cfg.n_heads % n_mp == 0


def apply_mlstm(p, cfg: MLSTMConfig, x, state=None, tp=None):
    """x: (B, L, D) train (``state=None``) or (B, 1, D) decode, which
    returns (y, state).

    With ``tp`` (:func:`mlstm_split`) ``p`` holds this rank's shards and
    ``x`` is replicated over MP; y is this rank's row-parallel part (the
    caller sums it over MP).  ``up_proj``'s block of ``[xi | z]`` is
    exchanged into this rank's channels of each, and ``xi`` gathered over
    MP: ``wq``/``wk``/``wv`` (this rank's columns) and the replicated
    gates read all of it.  Where the heads divide over MP
    (:func:`mlstm_heads_split`) the rank runs its heads, state and all;
    otherwise its q/k/v columns are gathered over MP and it runs every
    head, the state whole, and keeps its columns of the output.  Either
    way its gates' gradients are its part only (``Model.mp_partial``)."""
    from repro_torch.parallel.tensor import exchange_columns, gather_features
    B, L, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    up = x @ p["up_proj"]
    if tp is not None:
        up = exchange_columns(up, tp.grp)
    xi, z = torch.chunk(up, 2, dim=-1)                      # (B,L,Di[/n])
    xa = xi if tp is None else gather_features(xi, tp.grp)      # (B,L,Di)
    gif = (xa @ p["w_if"]).reshape(B, L, H, 2).float()
    qkv = [xa @ p[w] for w in ("wq", "wk", "wv")]
    h0, cols = 0, None
    if tp is not None and mlstm_heads_split(cfg, tp.n):
        H //= tp.n
        h0 = tp.index * H
    elif tp is not None:                         # the gathered-heads layout
        cols = xi.shape[-1]
        qkv = gather_features(torch.stack(qkv), tp.grp).unbind(0)
    q, k, v = (t.reshape(B, L, H, hd).float() for t in qkv)
    gif = gif.narrow(2, h0, H)
    logi = gif[..., 0] + p["b_i"].narrow(0, h0, H)
    logf = F.logsigmoid(gif[..., 1] + p["b_f"].narrow(0, h0, H))

    def out(y):
        y = y.reshape(B, -1, H * hd)
        if cols is not None:
            y = y.narrow(-1, tp.index * cols, cols)
        return (y.to(x.dtype) * F.silu(z)) @ p["down_proj"]

    if state is None:
        chunk = min(cfg.chunk, L)
        while L % chunk:
            chunk //= 2
        _, y = _mlstm_chunks(init_mlstm_state(cfg, B, x.device, heads=H),
                             (q, k, v, logi, logf), chunk)
        return out(y)

    carry, y = _mlstm_chunks(tuple(state), (q, k, v, logi, logf), 1)
    return out(y), carry


def init_mlstm_state(cfg: MLSTMConfig, batch, device="cuda", heads=None):
    """``(C, n, m)`` of zeros for ``heads`` heads (default all)."""
    H, hd = cfg.n_heads if heads is None else heads, cfg.head_dim
    f32 = torch.float32
    return (torch.zeros((batch, H, hd, hd), dtype=f32, device=device),
            torch.zeros((batch, H, hd), dtype=f32, device=device),
            torch.zeros((batch, H), dtype=f32, device=device))


# =============================== sLSTM ========================================

@dataclass(frozen=True)
class SLSTMConfig:
    d_model: int
    n_heads: int


def init_slstm(generator, cfg: SLSTMConfig, dtype=torch.float32):
    dev = generator.device
    D = cfg.d_model
    hd = D // cfg.n_heads
    p = {"w_x": dense_init(generator, (D, 4 * D), dtype=dtype)}
    # block-diagonal recurrent weights: (heads, hd, 4*hd)
    p["r_h"] = torch.randn((cfg.n_heads, hd, 4 * hd), generator=generator,
                           device=dev).div_(math.sqrt(hd)).to(dtype)
    p["bias"] = torch.cat([torch.zeros((D,), device=dev),
                           torch.full((D,), 3.0, device=dev),
                           torch.zeros((2 * D,), device=dev)])
    p["out_proj"] = dense_init(generator, (D, D), dtype=dtype)
    return p


def slstm_specs(mesh, mp_axes, cfg: SLSTMConfig):
    """The JAX function, copied."""
    return {"w_x": P(None, None), "r_h": P(None, None, None),
            "bias": P(None), "out_proj": P(None, None)}


def _slstm_step(p, cfg, carry, gx, eps):
    """One sLSTM step.  carry: (c, n, h, m) each (B, D); gx: (B, 4D);
    ``eps``: the normalizer's floor 1e-6 as a 0-d tensor on the device."""
    c, n, h, m = carry
    B, D = c.shape
    H = cfg.n_heads
    hd = D // H
    # JAX's einsum("bhd,hde->bhe"), as the batched product over heads
    # (f32 against a bf16 model's r_h: JAX's einsum promotes to f32)
    gr = torch.bmm(h.reshape(B, H, hd).transpose(0, 1),
                   p["r_h"].to(h.dtype))
    gr = gr.transpose(0, 1).reshape(B, 4 * D)
    g = (gx + gr + p["bias"]).float()
    gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
    gfm = gf + m
    m_new = torch.maximum(gfm, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(gfm - m_new)
    z = torch.tanh(gz)
    o = torch.sigmoid(go)
    c_new = f * c + i * z
    n_new = f * n + i
    h_new = o * c_new / torch.maximum(n_new, eps)
    return (c_new, n_new, h_new, m_new)


def apply_slstm(p, cfg: SLSTMConfig, x, state=None):
    """x: (B, L, D) train (``state=None``) or (B, 1, D) decode, which
    returns (y, state)."""
    B, L, D = x.shape
    gx = x @ p["w_x"]                                           # (B, L, 4D)
    eps = torch.tensor(1e-6, dtype=torch.float32, device=x.device)
    if state is None:
        z0 = torch.zeros((B, D), dtype=torch.float32, device=x.device)
        carry = (z0, z0, z0, z0)
        hs = []
        for g in torch.unbind(gx, dim=1):   # one gradient write, as split's
            carry = _slstm_step(p, cfg, carry, g, eps)
            hs.append(carry[2])
        y = torch.stack(hs, dim=1).to(x.dtype)
        return y @ p["out_proj"]
    carry = _slstm_step(p, cfg, tuple(state), gx[:, 0], eps)
    y = carry[2][:, None].to(x.dtype) @ p["out_proj"]
    return y, carry


def init_slstm_state(cfg: SLSTMConfig, batch, device="cuda"):
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return (z, z.clone(), z.clone(), z.clone())
