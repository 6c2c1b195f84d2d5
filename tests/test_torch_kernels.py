"""The port's kernel modules on the CPU: the plain PyTorch versions that
CPU tensors run (``repro_torch.kernels``) against the JAX package's Pallas
kernels (interpret mode, as tests/test_grouped_kernel.py runs them) and
its jnp oracles, on the same numpy inputs; the closed-form gradients of
dispatch, combine and the ragged FFN against ``jax.vjp``; and the wire
codec's bytes against the JAX package's ``wire_encode``.

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
from repro.core import collectives as jcoll  # noqa: E402
from repro.kernels.registry import KernelConfig as JKernelConfig  # noqa
from repro.kernels.registry import get_op as j_get_op  # noqa: E402
from repro_torch.core import collectives as tcoll  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.expert_ffn import expert_ffn  # noqa: E402
from repro_torch.kernels.expert_ffn_grouped import (  # noqa: E402
    expert_ffn_grouped, expert_ffn_ragged, slot_metadata)
from repro_torch.kernels.moe_dispatch import (moe_combine,  # noqa: E402
                                              moe_dispatch)
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


class TestDispatchCombineVsJax:
    """Dispatch with duplicate slots and the drop sentinel; combine with
    dropped choices.  A duplicate slot sums its tokens: 2 terms, in token
    order in all three implementations (f32 1e-5; bf16 one ulp)."""

    N_SLOTS = 12

    def _case(self, seed, k=K, m=M):
        rng = np.random.RandomState(seed)
        x = rng.randn(S, m).astype(np.float32)
        flat = rng.randint(0, self.N_SLOTS + 1, (S, k)).astype(np.int32)
        flat[0] = 3                            # one token, one slot k times
        flat[1, 0] = flat[2, k - 1] = 5        # two tokens, one slot
        flat[3] = self.N_SLOTS                 # every choice dropped
        w = rng.rand(S, k).astype(np.float32)
        return x, flat, w

    @pytest.mark.parametrize("backend", ["ref", "pallas"])
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_dispatch(self, backend, dtype):
        x, flat, _ = self._case(0)
        want = j_get_op("moe_dispatch", backend=backend,
                        n_slots=self.N_SLOTS)(_j(x, dtype), _j(flat))
        tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        got = moe_dispatch(_t(x, tdt), _t(flat), self.N_SLOTS)
        assert got.dtype == tdt and got.shape == (self.N_SLOTS, M)
        tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **tol)

    @pytest.mark.parametrize("backend", ["ref", "pallas"])
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_dispatch_sums_duplicates_in_token_order(self, backend, dtype):
        """Four choices of three tokens name slot 2, and random slots
        repeat elsewhere.  The JAX op (its jnp oracle, and the Pallas
        kernel in interpret mode) takes each slot's sum from 0 in token
        order, then choice order, rounded to the dtype after each addition:
        equal bitwise to that loop, the order the CUDA kernel keeps.  The
        rows' magnitudes make choice-then-token order give other bits,
        which the test checks too.  The port's plain version equals the
        loop, and the JAX op, bitwise in both dtypes."""
        big = 1e7 if dtype == jnp.float32 else 3e2
        rng = np.random.RandomState(9)
        x = rng.randn(S, M).astype(np.float32)
        x[1] *= big                              # twice into slot 2
        x[6] = -2.0 * x[1] + rng.randn(M).astype(np.float32)
        flat = rng.randint(3, self.N_SLOTS + 1, (S, K)).astype(np.int32)
        flat[1] = [2, 2]
        flat[4, 1] = flat[6, 0] = 2
        tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        tx = _t(x, tdt)
        entries = [(s, j) for s in range(S) for j in range(K)
                   if flat[s, j] < self.N_SLOTS]

        def loop_sum(order):
            acc = torch.zeros((self.N_SLOTS, M), dtype=tdt)
            for s, j in order:
                acc[flat[s, j]] = acc[flat[s, j]] + tx[s]
            return acc

        want = loop_sum(entries)
        by_choice = sorted(entries, key=lambda e: (e[1], e[0]))
        assert not torch.equal(want[2], loop_sum(by_choice)[2])
        jgot = j_get_op("moe_dispatch", backend=backend,
                        n_slots=self.N_SLOTS)(_j(x, dtype), _j(flat))
        np.testing.assert_array_equal(np.asarray(jgot.astype(jnp.float32)),
                                      want.float().numpy())
        got = moe_dispatch(tx, _t(flat), self.N_SLOTS)
        assert got.dtype == tdt
        assert torch.equal(got, want)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(jgot.astype(jnp.float32)))

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_combine_cotangent_sums_repeated_slots_as_jax(self, dtype):
        """Combine's buffer cotangent scatters ``w[s, j] * g[s]`` into the
        slots; where slots repeat, the registry's closed form sums them in
        entry order, rounded to the buffer's dtype after each addition:
        bitwise ``jax.vjp`` of the JAX combine, in bf16 too."""
        rng = np.random.RandomState(14)
        buf = rng.randn(self.N_SLOTS, M).astype(np.float32)
        g = rng.randn(S, M).astype(np.float32)
        g[1] *= 3e2                               # twice into slot 2
        g[6] = -2.0 * g[1] + rng.randn(M).astype(np.float32)
        flat = rng.randint(3, self.N_SLOTS + 1, (S, K)).astype(np.int32)
        flat[1] = [2, 2]
        flat[4, 1] = flat[6, 0] = 2
        w = (rng.rand(S, K) + 0.5).astype(np.float32)
        _, vjp = jax.vjp(lambda b: j_get_op("moe_combine")(
            b, _j(flat), _j(w)), _j(buf, dtype))
        want, = vjp(_j(g, dtype))
        tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        tb = _t(buf, tdt).requires_grad_(True)
        got, = torch.autograd.grad(
            get_op("moe_combine")(tb, _t(flat), _t(w)), tb, _t(g, tdt))
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))

    # k 1, 2 and 8 and an odd width: the shapes that pick the CUDA
    # kernel's unrolled instances and its scalar rows, where the card holds
    # it to this plain version
    @pytest.mark.parametrize("k,m", [(K, M), (1, M), (8, M), (K, 33)])
    @pytest.mark.parametrize("backend", ["ref", "pallas"])
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_combine(self, backend, dtype, k, m):
        _, flat, w = self._case(1, k, m)
        buf = np.random.RandomState(2).randn(self.N_SLOTS, m).astype(
            np.float32)
        want = j_get_op("moe_combine", backend=backend)(
            _j(buf, dtype), _j(flat), _j(w))
        tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        got = moe_combine(_t(buf, tdt), _t(flat), _t(w))
        assert got.dtype == tdt
        assert (got[3] == 0).all()             # every choice dropped
        tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **tol)

    def test_closed_form_gradients_match_jax(self):
        """The registry's closed-form transposes against ``jax.vjp`` of
        the JAX ops (f32; the same few-term sums)."""
        x, flat, w = self._case(3)
        buf = np.random.RandomState(4).randn(self.N_SLOTS, M).astype(
            np.float32)
        gd = np.random.RandomState(5).randn(self.N_SLOTS, M).astype(
            np.float32)
        gc = np.random.RandomState(6).randn(S, M).astype(np.float32)
        n = self.N_SLOTS
        _, vjp = jax.vjp(lambda a: j_get_op("moe_dispatch", n_slots=n)(
            a, _j(flat)), _j(x))
        want_x, = vjp(_j(gd))
        _, vjp = jax.vjp(lambda b, ww: j_get_op("moe_combine")(
            b, _j(flat), ww), _j(buf), _j(w))
        want_b, want_w = vjp(_j(gc))
        tx = _t(x).requires_grad_(True)
        got_x, = torch.autograd.grad(
            get_op("moe_dispatch", n_slots=n)(tx, _t(flat)), tx, _t(gd))
        tb, tw = _t(buf).requires_grad_(True), _t(w).requires_grad_(True)
        got_b, got_w = torch.autograd.grad(
            get_op("moe_combine")(tb, _t(flat), tw), (tb, tw), _t(gc))
        for got, want in ((got_x, want_x), (got_b, want_b),
                          (got_w, want_w)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **F32_TOL)


class TestExpertFfnVsJax:
    """``expert_ffn`` with T not a multiple of the Pallas token tile, and
    the ragged FFN with a count of 0, partial tiles and full tiles (the
    Pallas kernel run with 8-row tiles).  f32 1e-5 against the oracle,
    5e-4 against the Pallas kernel (the tolerance the JAX package's own
    tests give its kernel against its oracle)."""

    @pytest.mark.parametrize("backend", ["ref", "pallas"])
    @pytest.mark.parametrize("glu,act", [(True, "silu"), (False, "gelu")])
    def test_expert_ffn(self, backend, glu, act):
        rng = np.random.RandomState(8)
        x = rng.randn(E, 37, M).astype(np.float32)
        w1, w3, w2 = _weights(9, glu)
        want = j_get_op("expert_ffn", backend=backend, act=act)(
            _j(x), _j(w1), _j(w3), _j(w2))
        got = expert_ffn(_t(x), _t(w1), None if w3 is None else _t(w3),
                         _t(w2), act=act)
        tol = F32_TOL if backend == "ref" else dict(rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)

    COUNTS = np.array([[0, 24], [5, 8], [13, 0], [16, 3]], np.int32)

    @pytest.mark.parametrize("backend", ["ref", "pallas"])
    @pytest.mark.parametrize("glu,act", [(True, "silu"), (False, "gelu")])
    def test_ragged(self, backend, glu, act):
        rng = np.random.RandomState(10)
        xb = rng.randn(E, 2, 24, M).astype(np.float32)
        w1, w3, w2 = _weights(11, glu)
        want = j_get_op("expert_ffn_ragged", backend=backend, act=act,
                        cfg=JKernelConfig(block_t=8))(
            _j(xb), _j(self.COUNTS), _j(w1), _j(w3), _j(w2))
        got = expert_ffn_ragged(_t(xb), _t(self.COUNTS), _t(w1),
                                None if w3 is None else _t(w3), _t(w2),
                                act=act).numpy()
        tol = F32_TOL if backend == "ref" else dict(rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(got, np.asarray(want), **tol)
        for e in range(E):
            for g in range(2):
                n = int(self.COUNTS[e, g])
                assert (got[e, g, n:] == 0.0).all(), (e, g)
                assert (np.abs(got[e, g, :n]) > 0).any() or n == 0

    def test_ragged_bf16_keeps_its_dtype(self):
        rng = np.random.RandomState(12)
        xb = rng.randn(E, 2, 24, M).astype(np.float32)
        w1, w3, w2 = _weights(13, True)
        want = j_get_op("expert_ffn_ragged", backend="ref")(
            _j(xb, jnp.bfloat16), _j(self.COUNTS), _j(w1), _j(w3), _j(w2))
        got = expert_ffn_ragged(_t(xb, torch.bfloat16), _t(self.COUNTS),
                                _t(w1), _t(w3), _t(w2))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **BF16_TOL)

    def test_ragged_closed_form_gradient_matches_jax(self):
        rng = np.random.RandomState(14)
        xb = rng.randn(E, 2, 24, M).astype(np.float32)
        ct = rng.randn(E, 2, 24, M).astype(np.float32)
        w1, w3, w2 = _weights(15, True)
        _, vjp = jax.vjp(lambda *a: j_get_op("expert_ffn_ragged")(
            a[0], _j(self.COUNTS), *a[1:]), _j(xb), _j(w1), _j(w3), _j(w2))
        want = vjp(_j(ct))
        args = [_t(a).requires_grad_(True) for a in (xb, w1, w3, w2)]
        got = torch.autograd.grad(
            get_op("expert_ffn_ragged")(args[0], _t(self.COUNTS), *args[1:]),
            args, _t(ct))
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())


class TestWireCodecVsJax:
    """``wire_encode``'s bytes are the JAX package's: bf16, and fp8_e4m3
    with per-row absmax scaling (the f32 scale bitcast into a 4-byte tail)
    and without scaling (clipped at +-448); ``wire_decode`` inverts them
    to the same values."""

    @pytest.mark.parametrize("wire,scaling", [("bf16", "per_chunk"),
                                              ("fp8_e4m3", "per_chunk"),
                                              ("fp8_e4m3", "none")])
    def test_bytes(self, wire, scaling):
        x = np.random.RandomState(16).randn(64, 40).astype(np.float32)
        x[3] *= 1e3                         # past +-448 before scaling
        x[5] = 0.0                          # an all-zero row
        jc = jcoll.CommConfig(wire_dtype=wire, scaling=scaling)
        tc = tcoll.CommConfig(wire_dtype=wire, scaling=scaling)
        jw = jcoll.wire_encode(jnp.asarray(x), jc)
        tw = tcoll.wire_encode(_t(x), tc)
        assert tuple(tw.shape) == jw.shape
        np.testing.assert_array_equal(
            tw.contiguous().view(torch.uint8).numpy(),
            np.asarray(jw).view(np.uint8))
        np.testing.assert_array_equal(
            tcoll.wire_decode(tw, tc, torch.float32).numpy(),
            np.asarray(jcoll.wire_decode(jw, jc, jnp.float32)))

    def test_fp8_backward_reencodes_the_cotangent(self):
        """The fp8 round trip's backward is JAX's ``custom_vjp``: the
        cotangent goes through its own encode/decode."""
        rng = np.random.RandomState(17)
        x, g = rng.randn(8, 40).astype(np.float32), rng.randn(8, 40)
        g = (g * 1e-3).astype(np.float32)
        jc = jcoll.CommConfig(wire_dtype="fp8_e4m3")
        _, vjp = jax.vjp(lambda a: jcoll.wire_roundtrip(a, jc),
                         jnp.asarray(x))
        want, = vjp(jnp.asarray(g))
        tx = _t(x).requires_grad_(True)
        got, = torch.autograd.grad(
            tcoll.wire_roundtrip(tx, tcoll.CommConfig(wire_dtype="fp8_e4m3")),
            tx, _t(g))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert not np.array_equal(got.numpy(), g)


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
            get_op("no_such_op")

    def test_no_fallback_off_the_cpu(self):
        # a tensor that is neither on the CPU nor on a card gets no kernel
        # and no plain version: the device rule raises.  A meta tensor
        # (the dry run) gets the op's meta rule instead: empty outputs of
        # the kernel's shapes, its FLOPs and bytes charged, no launch
        from repro_torch.kernels import _build, meta
        x = torch.empty((2, 8), device="meta")
        with pytest.raises(RuntimeError, match="no kernel"):
            _build.on_card(x, "rmsnorm")
        before = (rmsnorm.launches, expert_ffn_grouped.launches)
        with meta.counting() as acc:
            y = rmsnorm(x, torch.empty((8,), device="meta"))
            z = expert_ffn_grouped(
                x, torch.empty((2, 1), dtype=torch.int32, device="meta"),
                torch.empty((2, 1), device="meta"),
                torch.empty((1, 8, 4), device="meta"), None,
                torch.empty((1, 4, 8), device="meta"), cap=8)
        assert y.is_meta and y.shape == x.shape and z.is_meta \
            and z.shape == x.shape
        assert acc["by_op"]["rmsnorm"] == [1, 4 * 2 * 8, 2 * 2 * 8 * 4 + 32]
        assert acc["by_op"]["expert_ffn_grouped"][1] == 2 * 2 * 2 * 8 * 4
        assert (rmsnorm.launches, expert_ffn_grouped.launches) == before

    def test_no_fallback_off_the_cpu_for_the_moe_ops(self):
        # as above: the device rule raises for every op's device check,
        # and a meta call answers through the meta rule, no launch
        from repro_torch.kernels import _build, meta
        flat = torch.empty((2, 1), dtype=torch.int32, device="meta")
        w1 = torch.empty((1, 8, 4), device="meta")
        w2 = torch.empty((1, 4, 8), device="meta")
        calls = {
            "moe_dispatch": (lambda: moe_dispatch(
                torch.empty((2, 8), device="meta"), flat, 4), (4, 8)),
            "moe_combine": (lambda: moe_combine(
                torch.empty((4, 8), device="meta"), flat,
                torch.empty((2, 1), device="meta")), (2, 8)),
            "expert_ffn": (lambda: expert_ffn(
                torch.empty((1, 3, 8), device="meta"), w1, None, w2),
                (1, 3, 8)),
            "expert_ffn_ragged": (lambda: expert_ffn_ragged(
                torch.empty((1, 1, 3, 8), device="meta"),
                torch.empty((1, 1), dtype=torch.int32, device="meta"), w1,
                None, w2), (1, 1, 3, 8))}
        fns = {"moe_dispatch": moe_dispatch, "moe_combine": moe_combine,
               "expert_ffn": expert_ffn,
               "expert_ffn_ragged": expert_ffn_ragged}
        for name, (call, shape) in calls.items():
            with pytest.raises(RuntimeError, match="no kernel"):
                _build.on_card(flat, name)
            before = fns[name].launches
            with meta.counting() as acc:
                out = call()
            assert out.is_meta and tuple(out.shape) == shape, name
            assert acc["by_op"][name][0] == 1 and acc["flops"] > 0, name
            assert fns[name].launches == before, name


def _shifted(shape, dtype=torch.float32):
    """A contiguous tensor that starts 4 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("case", ["aligned", "x_rows", "w_rows", "x_start",
                                  "w2_start", "bf16_rows"])
def test_grouped_check_rejects_misaligned(case):
    """The check a CUDA call passes before the grouped kernel's 16-byte
    cp.async copies, on CPU tensors: rows of x, w1/w3, w2 and the f32
    scratch, and every start address, must be 16-byte aligned."""
    from repro_torch.kernels import expert_ffn_grouped as g
    Mx, Fx, dt = {"x_rows": (130, 96, torch.float32),
                  "w_rows": (256, 98, torch.float32),
                  "bf16_rows": (260, 96, torch.bfloat16)}.get(
                      case, (256, 96, torch.float32))
    x = _shifted((8, Mx)) if case == "x_start" else torch.zeros((8, Mx),
                                                                dtype=dt)
    w1 = torch.zeros((4, Mx, Fx), dtype=dt)
    w2 = (_shifted((4, Fx, Mx)) if case == "w2_start"
          else torch.zeros((4, Fx, Mx), dtype=dt))
    flat = torch.zeros((8, 2), dtype=torch.int32)
    w = torch.zeros((8, 2))
    if case == "aligned":
        g._check(x, flat, w, w1, w1, w2, 4, "silu", "f32")
        return
    with pytest.raises(ValueError, match="16-byte"):
        g._check(x, flat, w, w1, w1, w2, 4, "silu", "f32")


@pytest.mark.parametrize("shift", [0, 1])
def test_flash_check_rejects_misaligned(shift):
    from repro_torch.kernels import flash_attention as fa
    shape = (1, 8, 2, 64)
    q = _shifted(shape) if shift else torch.zeros(shape)
    k = torch.zeros(shape)
    if not shift:
        fa._check(q, k, k, None)
        return
    with pytest.raises(ValueError, match="16-byte"):
        fa._check(q, k, k, None)
