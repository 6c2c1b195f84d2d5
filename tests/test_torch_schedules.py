"""Every Parm schedule through the port's plan IR on one rank
(``repro_torch.core.moe.apply_moe``) against the JAX ``apply_moe`` on a
(1, 1) ``("data", "model")`` mesh, on the same numpy inputs, on the CPU.

Each schedule of ``SCHEDULES`` runs in four cases, which between them
cover the two chunk counts (1 and 2: a base schedule with two chunks runs
its ``*_pipe`` body), the three wire formats and both pool kinds
(``infer``), with SwiGLU/silu and two-layer/gelu experts alternating.  The
gradient cases hold ``x``, ``wg``, ``w1``, ``w3`` and ``w2`` to
``jax.grad`` of one scalar loss under ``s1`` (f32 and bf16 wire),
``s1_pipe`` with two chunks and ``s1g`` with the fp8 wire: training's
backward through the wire round trip.

Tolerances, relative to the largest entry: y 1e-5 at f32 (the same sums in
another order); 1e-4 with a bf16 or fp8 wire: both packages round at the
same points, and these seeded inputs put no value within the frameworks'
last-bit difference of a bf16 or e4m3 rounding boundary (the largest
difference measured is 7e-7), while a skipped codec would move y by 4e-3
(bf16) or 4e-2 (fp8).  Gradients 1e-4 (the backward sums over tokens and
experts; measured at most 5e-7).  The routing (the gate's expert and slot
per choice, the drop fraction and the routed rows per expert) must match
exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import moe as jmoe  # noqa: E402
from repro.core.collectives import CommConfig  # noqa: E402
from repro.core.gating import topk_gate as j_topk_gate  # noqa: E402
from repro.core.schedules import SCHEDULES as J_SCHEDULES  # noqa: E402
from repro.parallel.mesh import ParallelDims, make_mesh  # noqa: E402
from repro_torch.core import executor as t_executor  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.core.collectives import CommConfig as TCommConfig  # noqa
from repro_torch.core.schedules import SCHEDULES  # noqa: E402

DIMS = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
M, F, E, K = 32, 48, 8, 2
# (wire, n_chunks, infer, glu/act): four cases per schedule
CASES = [("f32", 1, False, "glu"), ("bf16", 2, False, "gelu"),
         ("fp8_e4m3", 1, True, "glu"), ("fp8_e4m3", 2, False, "gelu")]
TOL = {"f32": 1e-5, "bf16": 1e-4, "fp8_e4m3": 1e-4}


def _cfgs(schedule, wire, n_chunks, variant, cf=1.0):
    kw = dict(d_model=M, d_ff=F, n_experts=E, top_k=K, capacity_factor=cf,
              normalize_topk=True, schedule=schedule,
              pipeline_chunks=n_chunks, glu=variant == "glu",
              act="silu" if variant == "glu" else "gelu")
    return (jmoe.MoEConfig(comm=CommConfig(wire_dtype=wire), **kw),
            tmoe.MoEConfig(comm=TCommConfig(wire_dtype=wire), **kw))


def _inputs(seed, glu, B=2, L=16):
    rng = np.random.RandomState(seed)
    p = {"wg": rng.randn(M, E) / np.sqrt(M),
         "w1": rng.randn(E, M, F) / np.sqrt(M),
         "w2": rng.randn(E, F, M) / np.sqrt(F)}
    if glu:
        p["w3"] = rng.randn(E, M, F) / np.sqrt(M)
    x = rng.randn(B, L, M)
    return x.astype(np.float32), {k: v.astype(np.float32)
                                  for k, v in p.items()}


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def test_the_ports_schedules_are_the_jax_packages():
    assert SCHEDULES == J_SCHEDULES


@pytest.mark.parametrize("wire,n_chunks,infer,variant", CASES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_apply_moe_matches_jax(schedule, wire, n_chunks, infer, variant,
                               monkeypatch):
    jcfg, tcfg = _cfgs(schedule, wire, n_chunks, variant)
    x, p = _inputs(7, tcfg.glu)
    mesh = make_mesh((1, 1), ("data", "model"))
    jy, jaux = jax.jit(lambda x, p: jmoe.apply_moe(
        x, p, mesh=mesh, dims=DIMS, cfg=jcfg, infer=infer))(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    gates = []

    def spy(*args):
        gates.append((args[3], t_topk_gate(*args)))
        return gates[-1][1]

    t_topk_gate = t_executor.topk_gate
    monkeypatch.setattr(t_executor, "topk_gate", spy)
    ty, taux = tmoe.apply_moe(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        cfg=tcfg, infer=infer)
    _close(ty.numpy(), jy, TOL[wire], "y")
    np.testing.assert_array_equal(taux["expert_load"].numpy(),
                                  np.asarray(jaux["expert_load"]))
    assert float(taux["drop_frac"]) == float(jaux["drop_frac"])
    for key in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=1e-6)
    # the gate the port's plan ran, against the JAX gate on the same pool
    (cap, g), = gates
    jg = j_topk_gate(jnp.asarray(x.reshape(-1, M)), jnp.asarray(p["wg"]),
                     jcfg.gate_config(), cap)
    np.testing.assert_array_equal(g.expert_idx.numpy(),
                                  np.asarray(jg.expert_idx))
    np.testing.assert_array_equal(g.slot_idx.numpy(),
                                  np.asarray(jg.slot_idx))
    if not infer:
        assert (g.slot_idx >= cap).any(), "the case must drop choices"


@pytest.mark.parametrize("schedule,wire,n_chunks", [
    ("s1", "f32", 1), ("s1", "bf16", 1), ("s1_pipe", "f32", 2),
    ("s1g", "fp8_e4m3", 1)])
def test_gradients_match_jax(schedule, wire, n_chunks):
    jcfg, tcfg = _cfgs(schedule, wire, n_chunks, "glu")
    x, p = _inputs(11, True)
    ct = np.random.RandomState(12).randn(*x.shape).astype(np.float32)
    mesh = make_mesh((1, 1), ("data", "model"))

    def jloss(x, p):
        y, aux = jmoe.apply_moe(x, p, mesh=mesh, dims=DIMS, cfg=jcfg)
        return jnp.sum(y * ct) + aux["aux_loss"] + aux["z_loss"]

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    y, aux = tmoe.apply_moe(tx, tp, cfg=tcfg)
    loss = (y * torch.from_numpy(ct)).sum() + aux["aux_loss"] \
        + aux["z_loss"]
    names = ["x", *sorted(tp)]
    grads = torch.autograd.grad(loss, [tx] + [tp[k] for k in sorted(tp)])
    want = [jg[0]] + [jg[1][k] for k in sorted(tp)]
    for name, got, w in zip(names, grads, want):
        _close(got.numpy(), w, 1e-4, f"d{name}")


def test_one_rank_schedules_are_bitwise_s1g_at_f32():
    """At f32 every schedule's output on one rank is s1g's, bit for bit, in
    the port as in JAX: the same dispatch, FFN and combine sums."""
    _, base = _cfgs("s1g", "f32", 1, "glu")
    x, p = _inputs(3, True)
    tx = torch.from_numpy(x)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want, _ = tmoe.apply_moe(tx, tp, cfg=base)
    for sched in SCHEDULES:
        for n in (1, 2, 4):
            cfg = dataclasses.replace(base, schedule=sched,
                                      pipeline_chunks=n)
            y, _ = tmoe.apply_moe(tx, tp, cfg=cfg)
            assert torch.equal(y, want), (sched, n)


def test_auto_is_s1g_with_one_chunk():
    _, cfg = _cfgs("auto", "f32", 4, "glu")
    assert tmoe.resolve_schedule(cfg) == ("s1g", 1)
    assert tmoe.resolve_schedule(cfg, "s2") == ("s2_pipe", 4)
    with pytest.raises(KeyError, match="unknown schedule"):
        tmoe.resolve_schedule(cfg, "s9")
