"""The port's gate (``repro_torch.core.gating``) against the JAX package's
on the same numpy inputs.

Routing is compared exactly: expert ids, slots, drop masks, flat slots,
per-expert load and routed rows.  That pins the two places where the
frameworks differ: ``lax.top_k`` breaks ties toward the lower index (the
port uses a stable descending sort; ``torch.topk`` would not) and the slot
assignment's stable argsort.  Float outputs (gate weights, aux and z
losses, drop fraction) agree within 1e-6 relative: the same softmax and
reductions, taken by two frameworks.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import gating as jg  # noqa: E402
from repro_torch.core import gating as tg  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(seed, S, M, E, *, ties=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(S, M).astype(np.float32)
    wg = (rng.randn(M, E) / np.sqrt(M)).astype(np.float32)
    if ties:
        wg[:] = 0.0               # uniform probabilities: every expert ties
    return x, wg


def _jax_gate(x, wg, cfg, cap):
    """The JAX gate under jit (eager dispatch of its sort path is slow)."""
    def f(x, wg):
        g = jg.topk_gate(x, wg, cfg, cap)
        return (g.expert_idx, g.slot_idx, g.weights, g.aux,
                g.flat(cap, cfg.n_experts))
    e, s, w, aux, flat = jax.jit(f)(jnp.asarray(x), jnp.asarray(wg))
    r = jg.GateResult(e, s, w, aux)
    r._flat[(cap, cfg.n_experts)] = flat
    return r


def _both(x, wg, E, k, cap, **kw):
    jcfg = jg.GateConfig(n_experts=E, top_k=k, **kw)
    tcfg = tg.GateConfig(n_experts=E, top_k=k, **kw)
    jr = _jax_gate(x, wg, jcfg, cap)
    tr = tg.topk_gate(torch.from_numpy(x), torch.from_numpy(wg), tcfg, cap)
    return jr, tr


def _assert_same(jr, tr, cap, E):
    np.testing.assert_array_equal(tr.expert_idx.numpy(),
                                  np.asarray(jr.expert_idx))
    np.testing.assert_array_equal(tr.slot_idx.numpy(),
                                  np.asarray(jr.slot_idx))
    np.testing.assert_array_equal(tr.flat(cap, E).numpy(),
                                  np.asarray(jr.flat(cap, E)))
    np.testing.assert_array_equal((tr.weights == 0).numpy(),
                                  np.asarray(jr.weights == 0))
    np.testing.assert_allclose(tr.weights.numpy(), np.asarray(jr.weights),
                               **TOL)
    for key in ("load", "routed"):
        np.testing.assert_array_equal(tr.aux[key].numpy(),
                                      np.asarray(jr.aux[key]))
    for key in ("aux_loss", "z_loss", "drop_frac"):
        np.testing.assert_allclose(float(tr.aux[key]), float(jr.aux[key]),
                                   **TOL)
    assert tr.expert_idx.dtype == tr.slot_idx.dtype == torch.int32
    assert tr.weights.dtype == torch.float32


@pytest.mark.parametrize("impl", ["sort", "cumsum"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("S,E,k,cf", [(64, 8, 2, 1.0), (40, 16, 4, 0.5),
                                      (8, 128, 8, 1.25), (33, 4, 4, 1.25)])
def test_topk_gate_matches_jax(impl, normalize, S, E, k, cf):
    x, wg = _inputs(S * E + k, S, 32, E)
    cap = jg.capacity(S, jg.GateConfig(n_experts=E, top_k=k,
                                       capacity_factor=cf))
    jr, tr = _both(x, wg, E, k, cap, capacity_factor=cf,
                   normalize_topk=normalize, impl=impl)
    _assert_same(jr, tr, cap, E)


@pytest.mark.parametrize("impl", ["sort", "cumsum"])
def test_uniform_probability_ties_break_to_lower_index(impl):
    x, wg = _inputs(0, 16, 32, 8, ties=True)
    jr, tr = _both(x, wg, 8, 3, 8, impl=impl, normalize_topk=True)
    _assert_same(jr, tr, 8, 8)
    assert (tr.expert_idx.numpy() == np.arange(3)).all()


def test_drops_are_choice_major():
    # tight capacity: every first choice outranks any second choice
    x, wg = _inputs(3, 48, 16, 4)
    jr, tr = _both(x, wg, 4, 2, 8)
    _assert_same(jr, tr, 8, 4)
    assert (tr.slot_idx >= 8).any()


def test_capacity_is_the_jax_float_ceiling():
    for tokens in (1, 7, 8, 64, 100, 513, 4096):
        for cf in (0.5, 1.0, 1.25, 2.0, 1.1):
            for E, k in ((4, 2), (128, 8), (8, 1), (16, 4)):
                kw = dict(n_experts=E, top_k=k, capacity_factor=cf)
                assert tg.capacity(tokens, tg.GateConfig(**kw)) == \
                    jg.capacity(tokens, jg.GateConfig(**kw)), (tokens, cf, E)


def test_flat_slots_sentinel():
    e = torch.tensor([[0, 3], [2, 1]], dtype=torch.int32)
    s = torch.tensor([[0, 9], [7, 1]], dtype=torch.int32)
    got = tg.flat_slots(e, s, 8, 4)
    want = jg.flat_slots(jnp.asarray(e.numpy()), jnp.asarray(s.numpy()), 8, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0, 1]) == 32
