"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the grouped kernel's contract (deterministic, row-independent,
NaN rows never leak, dropped choices skipped).  Marked ``cuda``: they skip
where there is no card, and run there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-5 relative (the same sums in another order), bf16 one
bf16 ulp (2e-2).  Nothing here imports JAX.
"""

import pytest
import torch

from repro_torch.core.gating import GateConfig, topk_gate
from repro_torch.kernels.expert_ffn_grouped import expert_ffn_grouped
from repro_torch.kernels.ref import expert_ffn_grouped_ref, rmsnorm_ref
from repro_torch.kernels.rmsnorm import rmsnorm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _moe(dev, S=24, M=256, F=96, E=16, k=4, cap=None, glu=True, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev).mul_(scale)

    x = randn(S, M)
    gate = GateConfig(n_experts=E, top_k=k)
    cap = cap or S
    r = topk_gate(x, randn(M, E, scale=M ** -0.5), gate, cap)
    ws = (randn(E, M, F, scale=M ** -0.5),
          randn(E, M, F, scale=M ** -0.5) if glu else None,
          randn(E, F, M, scale=F ** -0.5))
    return x, r.flat(cap, E), r.weights, ws, cap


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_rmsnorm_vs_plain(dev, dtype, tol):
    x = torch.randn(37, 2048, device=dev).to(dtype)
    scale = torch.rand(2048, device=dev) + 0.5
    torch.testing.assert_close(rmsnorm(x, scale, eps=1e-6),
                               rmsnorm_ref(x, scale, 1e-6), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("glu,act,wire,dtype,tol", [
    (True, "silu", "f32", torch.float32, 1e-5),
    (False, "gelu", "f32", torch.float32, 1e-5),
    (True, "silu", "bf16", torch.float32, 2e-2),
    (True, "gelu", "f32", torch.bfloat16, 2e-2),
])
def test_grouped_vs_plain(dev, glu, act, wire, dtype, tol):
    x, flat, w, (w1, w3, w2), cap = _moe(dev, glu=glu, cap=8)  # drops
    ws = [None if t is None else t.to(dtype) for t in (w1, w3, w2)]
    x = x.to(dtype)
    got = expert_ffn_grouped(x, flat, w, *ws, cap=cap, act=act, wire=wire)
    want = expert_ffn_grouped_ref(x, flat, w, *ws, cap=cap, act=act,
                                  wire=wire)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_grouped_is_deterministic_and_row_independent(dev):
    x, flat, w, (w1, w3, w2), cap = _moe(dev)
    a = expert_ffn_grouped(x, flat, w, w1, w3, w2, cap=cap)
    assert torch.equal(a, expert_ffn_grouped(x, flat, w, w1, w3, w2,
                                             cap=cap))
    # 8 live tokens alone, then behind 16 NaN rows (idle decode rows carry
    # NaN hidden states) sharing their experts' tiles: the live rows'
    # outputs must be bitwise the same.  The gate gets its logits directly
    # (x @ I is exact), so both runs route the live rows identically.
    E, M = w1.shape[0], w1.shape[1]
    gate = GateConfig(n_experts=E, top_k=4)
    eye = torch.eye(E, device=dev)
    logits = torch.randn(8, E, device=dev)
    live = x[:8]
    nan = float("nan")
    outs = []
    for n_mates in (0, 16):
        xs = torch.cat([torch.full((n_mates, M), nan, device=dev), live])
        lg = torch.cat([torch.full((n_mates, E), nan, device=dev), logits])
        r = topk_gate(lg, eye, gate, cap)
        outs.append(expert_ffn_grouped(xs, r.flat(cap, E), r.weights, w1,
                                       w3, w2, cap=cap)[n_mates:])
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1])
