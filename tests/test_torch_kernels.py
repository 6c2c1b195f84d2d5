"""The port's kernel modules on the CPU: the plain PyTorch versions that
CPU tensors run (``repro_torch.kernels``) against the JAX package's Pallas
kernels (interpret mode, as tests/test_grouped_kernel.py runs them) and
its jnp oracles, on the same numpy inputs.

Tolerances: f32 1e-5 (the same sums taken by two frameworks in different
orders, over at most 64 terms of O(1) values); a bfloat16 output or a bf16
wire round trip 2e-2 (a value near a rounding boundary may round to the
neighbouring bf16, 2^-8 relative, and the weighted sum carries that on).
Integer routing metadata must match exactly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.gating import GateConfig as JGateConfig  # noqa: E402
from repro.core.gating import capacity as j_capacity  # noqa: E402
from repro.core.gating import topk_gate as j_topk_gate  # noqa: E402
from repro.kernels import expert_ffn_grouped as j_grouped  # noqa: E402
from repro.kernels.registry import get_op as j_get_op  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.expert_ffn_grouped import (  # noqa: E402
    expert_ffn_grouped, slot_metadata)
from repro_torch.kernels.registry import KernelConfig, get_op  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402

S, M, F_, E, K = 16, 32, 64, 4, 2
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _routing(seed, *, n_tokens=S, cap_factor=1.25, skew=0.0):
    """Gate decisions from the JAX gate on numpy inputs: (x, flat, weights,
    cap).  ``skew`` biases every token toward expert 0 (drops)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n_tokens, M).astype(np.float32)
    wg = (rng.randn(M, E) / np.sqrt(M)).astype(np.float32)
    wg[:, 0] += skew * np.sign(x.mean(0))
    cfg = JGateConfig(n_experts=E, top_k=K, capacity_factor=cap_factor)
    cap = j_capacity(n_tokens, cfg)

    def route(x, wg):
        g = j_topk_gate(x, wg, cfg, cap)
        return g.flat(cap, E), g.weights

    flat, weights = jax.jit(route)(jnp.asarray(x), jnp.asarray(wg))
    return x, np.asarray(flat), np.asarray(weights), cap


def _weights(seed, glu):
    rng = np.random.RandomState(seed)
    w1 = (rng.randn(E, M, F_) / np.sqrt(M)).astype(np.float32)
    w3 = (rng.randn(E, M, F_) / np.sqrt(M)).astype(np.float32) if glu \
        else None
    w2 = (rng.randn(E, F_, M) / np.sqrt(F_)).astype(np.float32)
    return w1, w3, w2


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(dtype) if dtype is not None else t


def _j(a, dtype=None):
    return None if a is None else jnp.asarray(a, dtype)


def _port_grouped(x, flat, w, ws, cap, act, wire, dtype):
    w1, w3, w2 = ws
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    out = expert_ffn_grouped(
        _t(x, tdt), _t(flat), _t(w), _t(w1, tdt),
        None if w3 is None else _t(w3, tdt), _t(w2, tdt), cap=cap, act=act,
        wire=wire)
    assert out.dtype == tdt
    return out.float().numpy()


def _jax_grouped(backend, x, flat, w, ws, cap, act, wire, dtype):
    w1, w3, w2 = ws
    op = j_get_op("expert_ffn_grouped", backend=backend, cap=cap, act=act,
                  wire=wire)
    out = op(_j(x, dtype), _j(flat), _j(w), _j(w1, dtype), _j(w3, dtype),
             _j(w2, dtype))
    return np.asarray(out.astype(jnp.float32))


class TestGroupedVsJax:
    # glu x act x wire x dtype against the jnp oracle (fast)
    @pytest.mark.parametrize("glu,act", [(True, "silu"), (True, "gelu"),
                                         (False, "gelu"), (False, "silu")])
    @pytest.mark.parametrize("wire", ["f32", "bf16"])
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_vs_ref(self, glu, act, wire, dtype):
        x, flat, w, cap = _routing(0)
        ws = _weights(1, glu)
        got = _port_grouped(x, flat, w, ws, cap, act, wire, dtype)
        want = _jax_grouped("ref", x, flat, w, ws, cap, act, wire, dtype)
        tol = F32_TOL if (dtype == jnp.float32 and wire == "f32") \
            else BF16_TOL
        np.testing.assert_allclose(got, want, **tol)

    # the Pallas kernel itself (interpret mode), a representative subset
    @pytest.mark.parametrize("glu,act,wire,dtype", [
        (True, "silu", "f32", jnp.float32),
        (False, "gelu", "f32", jnp.float32),
        (True, "silu", "bf16", jnp.float32),
        (True, "gelu", "f32", jnp.bfloat16),
    ])
    def test_vs_pallas(self, glu, act, wire, dtype):
        x, flat, w, cap = _routing(2)
        ws = _weights(3, glu)
        got = _port_grouped(x, flat, w, ws, cap, act, wire, dtype)
        want = _jax_grouped("pallas", x, flat, w, ws, cap, act, wire, dtype)
        tol = F32_TOL if (dtype == jnp.float32 and wire == "f32") \
            else BF16_TOL
        np.testing.assert_allclose(got, want, **tol)

    @pytest.mark.parametrize("case", ["drops", "skew"])
    def test_drops_and_duplicate_expert_skew(self, case):
        # "drops": capacity below demand; "skew": most tokens pick expert 0
        kw = dict(cap_factor=0.5) if case == "drops" else dict(skew=4.0)
        x, flat, w, cap = _routing(4, n_tokens=32, **kw)
        assert (flat == E * cap).any(), "the case must drop choices"
        ws = _weights(5, True)
        for backend in ("ref", "pallas"):
            want = _jax_grouped(backend, x, flat, w, ws, cap, "silu", "f32",
                                jnp.float32)
            got = _port_grouped(x, flat, w, ws, cap, "silu", "f32",
                                jnp.float32)
            np.testing.assert_allclose(got, want, **F32_TOL)

    def test_slot_metadata_exact(self):
        x, flat, w, cap = _routing(6, n_tokens=32, cap_factor=0.5)
        rid, ws, cnt = slot_metadata(_t(flat), _t(w), 32, E, cap)
        jrid, jws, jcnt = j_grouped.slot_metadata(_j(flat), _j(w), 32, E, cap)
        np.testing.assert_array_equal(rid.numpy(), np.asarray(jrid))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
        np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
        assert rid.dtype == cnt.dtype == torch.int32


class TestRmsnormVsJax:
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    @pytest.mark.parametrize("backend", ["ref", "pallas"])
    def test_vs_jax(self, dtype, backend):
        rng = np.random.RandomState(7)
        x = rng.randn(24, 64).astype(np.float32) * 3.0
        scale = (1.0 + 0.1 * rng.randn(64)).astype(np.float32)
        want = np.asarray(j_get_op("rmsnorm", backend=backend, eps=1e-6)(
            _j(x, dtype), _j(scale)).astype(jnp.float32))
        tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        got = rmsnorm(_t(x, tdt), _t(scale), eps=1e-6)
        assert got.dtype == tdt
        tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
        np.testing.assert_allclose(got.float().numpy(), want, **tol)


class TestSeam:
    def test_get_op_binds_statics_and_follows_the_device(self):
        x = torch.randn(4, 8)
        out = get_op("rmsnorm", eps=1e-3)(x, torch.ones(8))
        torch.testing.assert_close(out, tref.rmsnorm_ref(x, torch.ones(8),
                                                         1e-3))

    def test_no_backend_override(self):
        with pytest.raises(ValueError, match="device"):
            get_op("rmsnorm", cfg=KernelConfig(backend="ref"))
        with pytest.raises(KeyError):
            get_op("moe_dispatch")

    def test_no_fallback_off_the_cpu(self):
        # a tensor that is neither on the CPU nor on a card gets no kernel
        # and no plain version: the wrapper raises
        x = torch.empty((2, 8), device="meta")
        with pytest.raises(RuntimeError, match="no kernel"):
            rmsnorm(x, torch.empty((8,), device="meta"))
        with pytest.raises(RuntimeError, match="no kernel"):
            expert_ffn_grouped(
                x, torch.empty((2, 1), dtype=torch.int32, device="meta"),
                torch.empty((2, 1), device="meta"),
                torch.empty((1, 8, 4), device="meta"), None,
                torch.empty((1, 4, 8), device="meta"), cap=8)
