"""The port's attention on the CPU against the JAX package, on the same
numpy inputs: the ``flash_attention`` op (its plain version, which CPU
tensors run) against the JAX Pallas kernel in interpret mode and the jnp
oracle; ``apply_attn`` on each of its branches against the JAX
``apply_attn`` with the default backend and with the Pallas kernel
(interpret mode); q/k/v gradients through the op's recompute backward
against ``jax.vjp``; and ``sdpa_flash_scan`` forward and backward at a
small KV block.

Tolerances: 2e-5 for f32 outputs (the same sums in two frameworks and, for
the Pallas kernel and the scan, an online softmax against a one-shot one:
the JAX package's own kernel tests use 2e-5) and 5e-5 for gradients (a
softmax backward adds one more rounded product per term).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.registry import KernelConfig as JKernelConfig  # noqa: E402
from repro.kernels.registry import get_op as j_get_op  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.registry import get_op  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
PALLAS = JKernelConfig(backend="pallas", interpret=True)


def _qkv(B, L, H, K, hd, seed, Lk=None):
    rng = np.random.RandomState(seed)
    Lk = Lk or L
    return (rng.randn(B, L, H, hd).astype(np.float32),
            rng.randn(B, Lk, K, hd).astype(np.float32),
            rng.randn(B, Lk, K, hd).astype(np.float32))


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


# (B, L, H, K, hd, causal, window): GQA 2:1 and 4:1, MHA, a window
# narrower than L, non-causal
OP_CASES = [(2, 64, 4, 2, 32, True, None), (1, 64, 4, 1, 64, True, None),
            (1, 64, 4, 4, 16, True, 16), (2, 48, 2, 2, 32, False, None)]


@pytest.mark.parametrize("B,L,H,K,hd,causal,window", OP_CASES)
def test_flash_op_matches_pallas_kernel_and_oracle(B, L, H, K, hd, causal,
                                                   window):
    q, k, v = _qkv(B, L, H, K, hd, seed=L + hd)
    got = flash_attention(*_t(q, k, v), causal=causal, window=window).numpy()
    pallas = j_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window)
    oracle = j_ref.flash_attention_ref(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), H // K, 2),
        jnp.repeat(jnp.asarray(v), H // K, 2), causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None)])
def test_flash_op_grads_match_jax_vjp(causal, window):
    """The registry op (forward, then backward by plain recompute) against
    ``jax.vjp`` of the JAX registry's Pallas op (interpret forward,
    ref-recompute backward)."""
    B, L, H, K, hd = 2, 32, 4, 2, 32
    q, k, v = _qkv(B, L, H, K, hd, seed=3)
    ct = np.random.RandomState(4).randn(B, L, H, hd).astype(np.float32)
    st = dict(causal=causal, window=window, scale=hd ** -0.5)
    tq, tk, tv = _t(q, k, v, grad=True)
    y = get_op("flash_attention", **st)(tq, tk, tv)
    tgrads = torch.autograd.grad(y, (tq, tk, tv), torch.from_numpy(ct))
    jop = j_get_op("flash_attention", cfg=PALLAS, **st)
    jy, vjp = jax.vjp(jop, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    for tg, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GRAD_TOL)


ATTN = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16)


def _attn_params(cfg, seed):
    rng = np.random.RandomState(seed)
    D, H, K, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        cfg["head_dim"]
    p = {"wq": rng.randn(D, H * hd) / np.sqrt(D),
         "wk": rng.randn(D, K * hd) / np.sqrt(D),
         "wv": rng.randn(D, K * hd) / np.sqrt(D),
         "wo": rng.randn(H * hd, D) / np.sqrt(H * hd)}
    if cfg.get("qkv_bias"):
        p.update(bq=0.1 * rng.randn(H * hd), bk=0.1 * rng.randn(K * hd),
                 bv=0.1 * rng.randn(K * hd))
    return {key: v.astype(np.float32) for key, v in p.items()}


# config overrides, positions given?  The branches: the flash op (GQA rope,
# MHA with qkv bias and no rope, a window), sdpa_full (chunked attention;
# explicit positions) and sdpa_flash_scan (above flash_threshold).
APPLY_CASES = {
    "op-gqa-rope": ({}, False),
    "op-bias-norope": (dict(n_kv_heads=4, qkv_bias=True, use_rope=False),
                       False),
    "op-window": (dict(window=8), False),
    "full-chunk": (dict(chunk=8), False),
    "full-positions": ({}, True),
    "scan": (dict(flash_threshold=16, flash_block=8, window=12), False),
}


@pytest.mark.parametrize("case,backend", [
    (case, backend) for case in APPLY_CASES
    for backend in (("default", "pallas") if case.startswith("op-")
                    else ("default",))])
def test_apply_attn_matches_jax(case, backend):
    """The JAX Pallas backend changes only the flash branch (its kernel
    covers contiguous self-attention without chunks), so the other
    branches run against the default backend alone."""
    over, with_pos = APPLY_CASES[case]
    kw = dict(ATTN, **over)
    p = _attn_params(kw, seed=1)
    x = np.random.RandomState(2).randn(2, 32, kw["d_model"]).astype(
        np.float32)
    pos = np.arange(32) + 5 if with_pos else None
    jcfg = j_attn.AttnConfig(**kw)
    tcfg = t_attn.AttnConfig(**kw)
    assert {f.name for f in dataclasses.fields(tcfg)} <= \
        {f.name for f in dataclasses.fields(jcfg)}
    jout = j_attn.apply_attn(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x),
        positions=None if pos is None else jnp.asarray(pos),
        kv_positions=None if pos is None else jnp.asarray(pos),
        kernel=PALLAS if backend == "pallas" else None)
    tout = t_attn.apply_attn(
        {k: torch.from_numpy(v) for k, v in p.items()}, tcfg,
        torch.from_numpy(x),
        positions=None if pos is None else torch.from_numpy(pos),
        kv_positions=None if pos is None else torch.from_numpy(pos))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_sdpa_flash_scan_matches_jax_forward_and_backward():
    kw = dict(ATTN, n_kv_heads=4, flash_block=8, window=20)
    B, L, H, hd = 2, 32, kw["n_heads"], kw["head_dim"]
    q, k, v = _qkv(B, L, H, H, hd, seed=6)
    ct = np.random.RandomState(7).randn(B, L, H, hd).astype(np.float32)
    pos = np.arange(L)
    jcfg, tcfg = j_attn.AttnConfig(**kw), t_attn.AttnConfig(**kw)

    def jf(q, k, v):
        return j_attn.sdpa_flash_scan(q, k, v, jcfg, jnp.asarray(pos),
                                      jnp.asarray(pos))

    jy, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(ct))
    tq, tk, tv = _t(q, k, v, grad=True)
    tpos = torch.from_numpy(pos)
    ty = t_attn.sdpa_flash_scan(tq, tk, tv, tcfg, tpos, tpos)
    tgrads = torch.autograd.grad(ty, (tq, tk, tv), torch.from_numpy(ct))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    for tg, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GRAD_TOL)
