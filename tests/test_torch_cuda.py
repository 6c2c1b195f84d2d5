"""The port's CUDA kernels on the card: each against its plain PyTorch
version, the grouped kernel's contract (deterministic, row-independent,
NaN rows never leak, dropped choices skipped), dispatch's exactness,
the dense and ragged FFN's row independence and exact zero tails, that a
CUDA tensor a kernel cannot take raises instead of falling back to the
plain version, and each op's gradient through the registry (recompute or
closed form) against the plain version's own; the grouped kernel's three
row-tile instances at counts that cut their tiles, and its FMA-order
contract: bitwise equal to dispatch -> expert_ffn -> combine; and that a
row or address the 16-byte copies cannot take raises.  rmsnorm's vector
and scalar paths, its rows' independence of the batch and its launch on
the current stream; dispatch's sums in token order (bitwise a loop on the
CPU), its rows written on dirty memory, its edge cases and its one launch
per call.  The dense and ragged FFN on all three row-tile instances and
mixed dtypes: bitwise the grouped kernel's pre-combine rows and each
other, dead ragged tiles written on dirty memory.  A training step taken
twice from one state, on each training path of the smoke at reduced
size: bitwise, with no deterministic flag.  The guarded step: clean,
bitwise the plain step; poisoned, the state bitwise untouched; the fp8
saturation counts on the card equal to the CPU's; a checkpoint restored
in place keeps each tensor's storage and ``requires_grad``.  Serving's
chaos plan on the card (the untouched requests bitwise their fault-free
streams) and a stage trace timed by CUDA events (the output unchanged by
the timer).  The cost model's fits on the card (R^2 > 0.8) and the
autoscheduler's measured calibration (finite candidates, the caller's
RNG, ordinals and fp8 monitor untouched, a cached second decision).
Marked ``cuda``: they skip where there is no card, and run there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-5 relative (the same sums in another order; flash
attention 2e-5: its online softmax rescales the running sums once per KV
tile), bf16 one bf16 ulp (2e-2).  Dispatch is bitwise: each slot's sum
in token order, then choice order, in the kernel and the plain version
alike.
Gradients: the same plain backward on the kernel's and the plain
version's saved inputs, so equal within 1e-5.
Nothing here imports JAX.
"""

import pytest
import torch

from repro_torch.core.gating import GateConfig, topk_gate
from repro_torch.kernels.expert_ffn import expert_ffn
from repro_torch.kernels.expert_ffn_grouped import (expert_ffn_grouped,
                                                    expert_ffn_ragged)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.moe_dispatch import moe_combine, moe_dispatch
from repro_torch.kernels.ref import (expert_ffn_grouped_ref,
                                     expert_ffn_ragged_ref, expert_ffn_ref,
                                     moe_combine_ref, moe_dispatch_ref,
                                     rmsnorm_ref)
from repro_torch.kernels.registry import get_op
from repro_torch.kernels.rmsnorm import kernel_path, rmsnorm

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


# (D, dtype, path): the 16-byte vector path's (threads per row, vectors
# per thread), every instance the rule picks, or None for the scalar path
# (rows not a multiple of 16 bytes, or wider than 8 vectors per thread at
# 256 threads)
RMS_PATHS = [(64, torch.float32, (32, 1)), (256, torch.float32, (32, 2)),
             (512, torch.float32, (32, 4)), (2048, torch.float32, (128, 4)),
             (4096, torch.float32, (256, 4)),
             (8192, torch.float32, (256, 8)), (130, torch.float32, None),
             (12288, torch.float32, None), (2048, torch.bfloat16, (64, 4)),
             (2056, torch.bfloat16, (128, 4)), (2052, torch.bfloat16, None)]


@pytest.mark.parametrize("D,dtype,path", RMS_PATHS)
def test_rmsnorm_paths_vs_plain(dev, D, dtype, path):
    """Each path the wrapper picks by shape, against the plain version
    (f32 1e-5, bf16 one ulp); a start address off 16 bytes takes the
    scalar path with the same result."""
    g = torch.Generator(device=dev).manual_seed(D)
    x = torch.randn((19, D), generator=g, device=dev).mul_(3).to(dtype)
    scale = torch.rand((D,), generator=g, device=dev) + 0.5
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert kernel_path(x, scale, torch.empty_like(x)) == path
    n0 = rmsnorm.launches
    got = rmsnorm(x, scale, eps=1e-6)
    assert rmsnorm.launches == n0 + 1
    want = rmsnorm_ref(x, scale, 1e-6)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    shifted = torch.empty(x.numel() + 8, dtype=dtype, device=dev)[
        1:x.numel() + 1].view(x.shape)
    shifted.copy_(x)
    assert kernel_path(shifted, scale, shifted) is None
    torch.testing.assert_close(rmsnorm(shifted, scale, eps=1e-6).float(),
                               want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("D,dtype,path", RMS_PATHS)
def test_rmsnorm_row_is_independent_of_the_batch(dev, D, dtype, path):
    """A row's bits are the same normalised alone, in any batch, at any
    position (blocks of 1, 2, 4 or 8 rows cut the batch differently): the
    sum of squares depends on the row and D alone."""
    g = torch.Generator(device=dev).manual_seed(D + 1)
    x = torch.randn((40, D), generator=g, device=dev).to(dtype)
    scale = torch.rand((D,), generator=g, device=dev) + 0.5
    full = rmsnorm(x, scale)
    for r in (0, 17, 39):
        assert torch.equal(rmsnorm(x[r:r + 1].contiguous(), scale),
                           full[r:r + 1])
    assert torch.equal(rmsnorm(x[5:13].contiguous(), scale), full[5:13])


def test_rmsnorm_follows_the_current_stream(dev):
    """A launch inside ``torch.cuda.stream(side)`` is ordered on ``side``:
    it reads x after the side stream's earlier (slow) write of x."""
    x = torch.zeros((64, 2048), device=dev)
    new = torch.randn((64, 2048), device=dev)
    scale = torch.rand((2048,), device=dev) + 0.5
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)          # tens of ms on the card
        x.copy_(new)
        got = rmsnorm(x, scale)
    side.synchronize()
    torch.testing.assert_close(got, rmsnorm_ref(new, scale), rtol=1e-5,
                               atol=1e-5)


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


# The grouped kernel's row-tile instances, as csrc/expert_ffn_grouped.cu
# picks them from the capacity: 16 rows up to cap 48, 64 up to 320, else
# 128.  Each is run at routed rows per expert of 1, BM-1, BM, BM+1 and
# 2 BM + 3 (a lone row, tiles cut one short, exact, one over, and a third
# tile of 3 rows), with F = 200 and M = 136 (neither a multiple of the 128
# B columns nor M of the 32-deep slab).
ROW_TILES = [(16, 40), (64, 200), (128, 400)]          # (BM, cap)


def _routed(dev, counts, cap, M, k=2, seed=0):
    """x (S, M), flat slots (S, k) and f32 gate weights that give expert e
    exactly ``counts[e]`` routed rows (its slots 0..counts[e]-1, dealt to
    the tokens in a random order); the unused choices of the last token
    are dropped (``E * cap``)."""
    g = torch.Generator().manual_seed(seed)
    E = len(counts)
    slots = torch.cat([e * cap + torch.arange(c)
                       for e, c in enumerate(counts)])
    slots = slots[torch.randperm(len(slots), generator=g)]
    S = -(-len(slots) // k)
    flat = torch.full((S * k,), E * cap, dtype=torch.int32)
    flat[:len(slots)] = slots
    x = torch.randn((S, M), generator=g)
    w = torch.rand((S, k), generator=g)
    return x.to(dev), flat.reshape(S, k).to(dev), w.to(dev)


def _expert_weights(dev, E, M, F, glu, seed=1):
    g = torch.Generator().manual_seed(seed)
    w1 = torch.randn((E, M, F), generator=g) * M ** -0.5
    w3 = torch.randn((E, M, F), generator=g) * M ** -0.5 if glu else None
    w2 = torch.randn((E, F, M), generator=g) * F ** -0.5
    return [None if t is None else t.to(dev) for t in (w1, w3, w2)]


@pytest.mark.parametrize("bm,cap", ROW_TILES)
@pytest.mark.parametrize("glu,act,xdt,wdt,wire,tol", [
    (True, "silu", torch.float32, torch.float32, "f32", 1e-5),
    (False, "gelu", torch.float32, torch.float32, "f32", 1e-5),
    (True, "gelu", torch.bfloat16, torch.bfloat16, "f32", 2e-2),
    (False, "silu", torch.bfloat16, torch.bfloat16, "bf16", 2e-2),
    (True, "silu", torch.float32, torch.float32, "bf16", 2e-2),
    (True, "silu", torch.float32, torch.bfloat16, "f32", 1e-5),
])
def test_grouped_row_tiles_vs_plain(dev, bm, cap, glu, act, xdt, wdt, wire,
                                    tol):
    M, F = 136, 200
    counts = [1, bm - 1, bm, bm + 1, 2 * bm + 3]
    x, flat, w = _routed(dev, counts, cap, M)
    ws = [None if t is None else t.to(wdt)
          for t in _expert_weights(dev, len(counts), M, F, glu)]
    x = x.to(xdt)
    n0 = expert_ffn_grouped.launches
    got = expert_ffn_grouped(x, flat, w, *ws, cap=cap, act=act, wire=wire)
    torch.cuda.synchronize()
    assert expert_ffn_grouped.launches == n0 + 1
    want = expert_ffn_grouped_ref(x, flat, w, *ws, cap=cap, act=act,
                                  wire=wire)
    assert got.dtype == xdt and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, expert_ffn_grouped(x, flat, w, *ws, cap=cap,
                                               act=act, wire=wire))


@pytest.mark.parametrize("bm,cap", ROW_TILES)
@pytest.mark.parametrize("glu,act", [(True, "silu"), (False, "gelu")])
def test_grouped_is_bitwise_the_dense_path(dev, bm, cap, glu, act):
    """At f32 with no wire, every output element of every row-tile
    instance is the same fmaf chain as dispatch -> expert_ffn -> combine
    computes: the two agree bit for bit."""
    M, F = 136, 200
    counts = [1, bm - 1, bm, bm + 1, 2 * bm + 3]
    E = len(counts)
    x, flat, w = _routed(dev, counts, cap, M, seed=bm)
    w1, w3, w2 = _expert_weights(dev, E, M, F, glu, seed=bm + 1)
    got = expert_ffn_grouped(x, flat, w, w1, w3, w2, cap=cap, act=act)
    pool = moe_dispatch(x, flat, E * cap).reshape(E, cap, M)
    dense = expert_ffn(pool, w1, w3, w2, act=act).reshape(E * cap, M)
    assert torch.equal(got, moe_combine(dense, flat, w))


def test_kernels_reject_misaligned_rows(dev):
    """The 16-byte cp.async copies need 16-byte rows and start addresses:
    anything else raises ValueError, in the grouped, dense and ragged FFN
    and in flash attention; nothing falls back."""
    x, flat, w, (w1, w3, w2), cap = _moe(dev, M=130)      # 520-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        expert_ffn_grouped(x, flat, w, w1, w3, w2, cap=cap)
    x, flat, w, (w1, w3, w2), cap = _moe(dev, F=98)       # 392-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        expert_ffn_grouped(x, flat, w, w1, w3, w2, cap=cap)
    x, flat, w, (w1, w3, w2), cap = _moe(dev)
    shifted = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="16-byte"):
        expert_ffn_grouped(shifted, flat, w, w1, w3, w2, cap=cap)
    E = w1.shape[0]
    for bad in (dict(M=130), dict(F=98)):                 # 520 / 392 bytes
        _, _, _, (v1, v3, v2), _ = _moe(dev, **bad)
        xb = torch.randn((E, 8, v1.shape[1]), device=dev)
        with pytest.raises(ValueError, match="16-byte"):
            expert_ffn(xb, v1, v3, v2)
        counts = torch.full((E, 1), 8, dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="16-byte"):
            expert_ffn_ragged(xb[:, None], counts, v1, v3, v2)
    xb = torch.randn((E, 8, x.shape[1]), device=dev)
    xs = torch.empty(xb.numel() + 1, device=dev)[1:].view(xb.shape)
    xs.copy_(xb)
    with pytest.raises(ValueError, match="16-byte"):
        expert_ffn(xs, w1, w3, w2)
    counts = torch.full((E, 1), 8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        expert_ffn_ragged(xs[:, None], counts, w1, w3, w2)
    q = torch.randn((1, 64, 4, 64), device=dev)
    qs = torch.empty(q.numel() + 2, device=dev)[2:].view(q.shape)
    qs.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(qs, q, q)


# (B, Lq, Lk, H, K, hd, dtype, causal, window, tol): GQA and MHA, both
# head dims, ragged tiles, Lq != Lk (positions
# aligned at the top), a window narrower than L (rows whose first visited
# tile is fully masked), non-causal, and bf16.
FLASH_CASES = [
    (2, 128, 128, 8, 2, 128, torch.float32, True, None, 2e-5),
    (2, 96, 96, 4, 4, 64, torch.float32, True, None, 2e-5),
    (1, 200, 200, 4, 1, 64, torch.float32, True, 48, 2e-5),
    (1, 256, 256, 4, 2, 128, torch.float32, False, 100, 2e-5),
    (2, 64, 160, 4, 2, 64, torch.float32, False, None, 2e-5),
    (1, 100, 130, 4, 4, 128, torch.float32, True, None, 2e-5),
    (1, 160, 96, 4, 2, 64, torch.float32, True, None, 2e-5),
    (2, 128, 128, 8, 2, 128, torch.bfloat16, True, None, 2e-2),
    (1, 192, 192, 4, 4, 64, torch.bfloat16, True, 40, 2e-2),
    # L not a multiple of the query tile (128 rows) nor of the KV tile (64
    # keys), at both head dims
    (2, 200, 200, 4, 2, 64, torch.float32, True, None, 2e-5),
    (1, 300, 300, 8, 2, 128, torch.float32, True, 70, 2e-5),
    (1, 150, 270, 4, 1, 128, torch.float32, True, None, 2e-5),
    (1, 270, 150, 4, 4, 64, torch.float32, False, 130, 2e-5),
    # windowed tiles with unmasked interiors and a late first tile
    (1, 1100, 1100, 2, 1, 64, torch.float32, True, 300, 2e-5),
    (1, 700, 700, 4, 2, 128, torch.float32, True, 200, 2e-5),
    (2, 333, 333, 4, 2, 128, torch.bfloat16, True, None, 2e-2),
    (1, 190, 190, 6, 3, 64, torch.bfloat16, True, 50, 2e-2),
]


@pytest.mark.parametrize("B,Lq,Lk,H,K,hd,dtype,causal,window,tol",
                         FLASH_CASES)
def test_flash_attention_vs_plain(dev, B, Lq, Lk, H, K, hd, dtype, causal,
                                  window, tol):
    g = torch.Generator(device=dev).manual_seed(Lq + hd)
    q = torch.randn((B, Lq, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Lk, K, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Lk, K, hd), generator=g, device=dev).to(dtype)
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, flash_attention(q, k, v, causal=causal,
                                            window=window))


def test_flash_attention_rejects_what_it_cannot_take(dev):
    q = torch.zeros((1, 8, 2, 32), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.zeros((1, 8, 4, 64), device=dev)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, q[:, :, :3].contiguous(), q[:, :, :3].contiguous())
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)


def _grad_case(name, dev):
    """(op, plain, args, differentiable positions) on the card."""
    g = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev).mul_(scale)

    if name == "rmsnorm":
        return (get_op("rmsnorm", eps=1e-6),
                lambda x, s: rmsnorm_ref(x, s, 1e-6),
                [randn(64, 256), 1.0 + 0.1 * randn(256)], (0, 1))
    if name == "flash_attention":
        st = dict(causal=True, window=None, scale=0.125)
        return (get_op("flash_attention", **st),
                lambda q, k, v: flash_attention_plain(q, k, v, **st),
                [randn(2, 96, 8, 64), randn(2, 96, 2, 64),
                 randn(2, 96, 2, 64)], (0, 1, 2))
    x, flat, w, (w1, w3, w2), cap = _moe(dev, cap=8)
    E, M = w1.shape[0], w1.shape[1]
    if name == "moe_dispatch":
        return (get_op("moe_dispatch", n_slots=E * cap),
                lambda x, f: moe_dispatch_ref(x, f, E * cap), [x, flat],
                (0,))
    if name == "moe_combine":
        buf = randn(E * cap, M)
        return (get_op("moe_combine"), moe_combine_ref, [buf, flat, w],
                (0, 2))
    if name == "expert_ffn":
        return (get_op("expert_ffn", act="silu"),
                lambda *a: expert_ffn_ref(*a, act="silu"),
                [randn(E, 21, M), w1, w3, w2], (0, 1, 2, 3))
    if name == "expert_ffn_ragged":
        counts = torch.randint(0, 22, (E, 2), generator=g, device=dev,
                               dtype=torch.int32)
        return (get_op("expert_ffn_ragged", act="silu"),
                lambda *a: expert_ffn_ragged_ref(*a, act="silu"),
                [randn(E, 2, 21, M), counts, w1, w3, w2], (0, 2, 3, 4))
    return (get_op("expert_ffn_grouped", cap=cap, act="silu", wire="f32"),
            lambda *a: expert_ffn_grouped_ref(*a, cap=cap, act="silu",
                                              wire="f32"),
            [x, flat, w, w1, w3, w2], (0, 2, 3, 4, 5))


@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention",
                                  "expert_ffn_grouped", "expert_ffn",
                                  "expert_ffn_ragged", "moe_dispatch",
                                  "moe_combine"])
def test_op_gradient_is_the_plain_versions(dev, name):
    """Forward through the kernel, backward by plain recompute or the
    closed-form transpose: the gradient equals the plain version's own
    autograd gradient."""
    op, plain, args, diff = _grad_case(name, dev)
    outs, grads = [], []
    for fn in (op, plain):
        leaves = [a.detach().clone().requires_grad_(i in diff)
                  for i, a in enumerate(args)]
        y = fn(*leaves)
        ct = torch.linspace(-1, 1, y.numel(), device=dev).reshape(y.shape)
        grads.append(torch.autograd.grad(y, [leaves[i] for i in diff], ct))
        outs.append(y.detach())
    torch.testing.assert_close(outs[0], outs[1], rtol=2e-5, atol=2e-5)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _slots(dev, S=300, k=2, E=8, cap=64, seed=7):
    """A gate's flat slots for S tokens: distinct kept slots, some drops."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((S, 96), generator=g, device=dev)
    r = topk_gate(x, torch.randn((96, E), generator=g, device=dev),
                  GateConfig(n_experts=E, top_k=k), cap)
    return r.flat(cap, E), r.weights, E * cap


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_dispatch_vs_plain(dev, dtype):
    flat, _, n_slots = _slots(dev)
    assert (flat == n_slots).any(), "the case must drop choices"
    x = torch.randn((flat.shape[0], 200), device=dev).to(dtype)
    n0 = moe_dispatch.launches
    got = moe_dispatch(x, flat, n_slots)
    torch.cuda.synchronize()
    assert moe_dispatch.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (n_slots, 200)
    assert torch.equal(got, moe_dispatch_ref(x, flat, n_slots))


def _loop_sum(x, flat, n_slots):
    """The dispatch contract written as a loop on the CPU: each slot's sum
    from 0 in token order, then choice order, rounded to x's dtype after
    each addition."""
    x, flat = x.cpu(), flat.cpu().tolist()
    acc = torch.zeros((n_slots, x.shape[1]), dtype=x.dtype)
    for s, row in enumerate(flat):
        for slot in row:
            if 0 <= slot < n_slots:
                acc[slot] = acc[slot] + x[s]
    return acc


def test_moe_dispatch_sums_duplicate_slots(dev):
    """64 tokens into one slot (and random repeats): bitwise the loop sum
    in token order, and bitwise the plain version, which adds a slot's
    terms one occurrence rank at a time in the same order."""
    x = torch.randn((64, 130), device=dev)
    flat = torch.randint(0, 9, (64, 3), device=dev, dtype=torch.int32)
    flat[:, 0] = 2                     # 64 tokens into one slot
    flat[5] = 8                        # the drop sentinel (n_slots = 8)
    got = moe_dispatch(x, flat, 8)
    assert torch.equal(got.cpu(), _loop_sum(x, flat, 8))
    assert torch.equal(got, moe_dispatch_ref(x, flat, 8))


# (S, k, M, n_slots, dtype): M 130 f32 and 260 bf16 take the scalar path
# (rows not a multiple of 16 bytes), the others 16-byte vectors; 40 slots
# fill 5 blocks of 8 rows, 2000 slots 250 of them, and 30000 slots blocks
# of about 60 rows (four blocks per SM), whose edges the random repeats
# straddle
DISPATCH_CASES = [(96, 3, 256, 40, torch.float32),
                  (96, 3, 130, 40, torch.float32),
                  (96, 3, 256, 40, torch.bfloat16),
                  (96, 3, 260, 40, torch.bfloat16),
                  (500, 4, 64, 2000, torch.float32),
                  (500, 4, 64, 2000, torch.bfloat16),
                  (4000, 2, 32, 30000, torch.float32)]


@pytest.mark.parametrize("S,k,M,n_slots,dtype", DISPATCH_CASES)
def test_moe_dispatch_duplicates_bitwise_in_token_order(dev, S, k, M,
                                                        n_slots, dtype):
    """Repeated slots, three or more choices on some, drops, and pairs of
    repeats on both sides of every 8-row block edge: the kernel and the
    plain version on the card and on the CPU, each bitwise the token-order
    loop sum (bf16: rounded after each addition)."""
    g = torch.Generator(device=dev).manual_seed(S + M)
    x = torch.randn((S, M), generator=g, device=dev).mul_(50).to(dtype)
    flat = torch.randint(0, n_slots + 1, (S, k), generator=g, device=dev,
                         dtype=torch.int32)
    flat[:8, 0] = 3                              # eight tokens, one slot
    flat[8:12] = 5                               # every choice, one slot
    edges = torch.arange(8, min(n_slots, 8 * (S // 4)), 8, device=dev,
                         dtype=torch.int32)[:S // 4 - 4]
    n_e = edges.numel()
    flat[12:12 + n_e, 0] = edges - 1             # rows 7 | 8, 15 | 16 ...
    flat[12 + n_e:12 + 2 * n_e, 0] = edges
    flat[12 + 2 * n_e:12 + 3 * n_e, 0] = edges - 1
    flat[12 + 3 * n_e:12 + 4 * n_e, 0] = edges
    got = moe_dispatch(x, flat, n_slots)
    assert got.dtype == dtype and got.shape == (n_slots, M)
    want = _loop_sum(x, flat, n_slots)
    assert torch.equal(got.cpu(), want)
    # the plain version on the card (CUDA's sorted accumulating
    # index_put_) and on the CPU (one pass per occurrence rank) alike
    assert torch.equal(moe_dispatch_ref(x, flat, n_slots).cpu(), want)
    assert torch.equal(moe_dispatch_ref(x.cpu(), flat.cpu(), n_slots), want)


def test_moe_dispatch_more_entries_than_a_block_lists(dev):
    """4096 tokens into one slot (more than the 256 entries each warp of a
    block lists in shared memory) and one into each of its neighbours: the
    block sums by scanning flat itself, still in token order, bitwise."""
    S = 4096
    x = torch.randn((S, 256), device=dev)
    flat = torch.full((S, 2), 64, dtype=torch.int32, device=dev)
    flat[:, 0] = 9
    flat[0, 1], flat[1, 1] = 8, 10
    flat[2, 1] = 9
    got = moe_dispatch(x, flat, 64)
    assert torch.equal(got.cpu(), _loop_sum(x, flat, 64))


def test_moe_dispatch_writes_every_row_on_dirty_memory(dev):
    """The caching allocator hands the buffer back full of NaNs: every row
    no choice names comes out exactly 0 (no memset: the kernel writes it),
    and the rest equal the plain version bitwise."""
    flat, _, n_slots = _slots(dev)
    x = torch.randn((flat.shape[0], 200), device=dev)
    torch.cuda.synchronize()
    dirty = torch.full((n_slots, 200), float("nan"), device=dev)
    del dirty                                    # back to the cache
    got = moe_dispatch(x, flat, n_slots)
    unused = torch.ones(n_slots + 1, dtype=torch.bool, device=dev)
    unused[flat.reshape(-1).long()] = False
    assert bool((got[unused[:-1]] == 0).all())
    assert not bool(got.isnan().any())
    assert torch.equal(got, moe_dispatch_ref(x, flat, n_slots))


def test_moe_dispatch_edge_cases(dev):
    """No tokens, every choice dropped: all rows 0.  No slots: an empty
    buffer and no launch."""
    for S in (0, 37):
        x = torch.randn((S, 64), device=dev)
        flat = torch.full((S, 2), 50, dtype=torch.int32, device=dev)
        n0 = moe_dispatch.launches
        got = moe_dispatch(x, flat, 50)
        assert moe_dispatch.launches == n0 + 1
        assert got.shape == (50, 64) and bool((got == 0).all())
    x = torch.randn((5, 64), device=dev)
    n0 = moe_dispatch.launches
    got = moe_dispatch(x, torch.zeros((5, 2), dtype=torch.int32, device=dev),
                       0)
    assert got.shape == (0, 64) and moe_dispatch.launches == n0


def test_moe_dispatch_is_one_kernel_launch(dev):
    """One call is one kernel on the card: no memset, nothing else."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flat, _, n_slots = _slots(dev)
    x = torch.randn((flat.shape[0], 256), device=dev)
    moe_dispatch(x, flat, n_slots)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        moe_dispatch(x, flat, n_slots)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "dispatch_kernel" in names[0], names


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2e-2)])
def test_moe_combine_vs_plain(dev, dtype, tol):
    flat, w, n_slots = _slots(dev)
    buf = torch.randn((n_slots, 200), device=dev).to(dtype)
    n0 = moe_combine.launches
    got = moe_combine(buf, flat, w)
    torch.cuda.synchronize()
    assert moe_combine.launches == n0 + 1
    assert got.dtype == dtype
    dropped = (flat == n_slots).all(dim=1)
    assert torch.equal(got[dropped], torch.zeros_like(got[dropped]))
    torch.testing.assert_close(got.float(),
                               moe_combine_ref(buf, flat, w).float(),
                               rtol=tol, atol=tol)


# T rows per expert: 8 and 37 take the 16-row tiles (1-3 live 16-row
# groups), 160 the 64-row ones (64 + 64 + 32), 300 the 128-row ones (128 +
# 128 + 44: 1-8 live groups a tile); mixed x / weight dtypes take the 64-row
# ones at any T
@pytest.mark.parametrize("T", [8, 37, 160, 300])
@pytest.mark.parametrize("glu,act,xdt,wdt,tol", [
    (True, "silu", torch.float32, torch.float32, 1e-5),
    (False, "gelu", torch.float32, torch.float32, 1e-5),
    (True, "silu", torch.bfloat16, torch.bfloat16, 2e-2),
    (True, "silu", torch.float32, torch.bfloat16, 1e-5),
    (False, "silu", torch.bfloat16, torch.float32, 1e-5)])
def test_expert_ffn_vs_plain_and_row_independent(dev, T, glu, act, xdt, wdt,
                                                 tol):
    x, _, _, (w1, w3, w2), _ = _moe(dev, glu=glu)
    E, M = w1.shape[0], w1.shape[1]
    xb = torch.randn((E, T, M), device=dev).to(xdt)
    ws = [None if t is None else t.to(wdt) for t in (w1, w3, w2)]
    n0 = expert_ffn.launches
    got = expert_ffn(xb, *ws, act=act)
    torch.cuda.synchronize()
    assert expert_ffn.launches == n0 + 1
    want = expert_ffn_ref(xb, *ws, act=act)
    assert got.dtype == want.dtype == torch.promote_types(xdt, wdt)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # capacity chunks (the *_pipe bodies), each on its own row tiles, give
    # the same rows bitwise
    cut = T // 2 + 1
    parts = [expert_ffn(xb[:, a:b].contiguous(), *ws, act=act)
             for a, b in ((0, cut), (cut, T))]
    assert torch.equal(torch.cat(parts, dim=1), got)


@pytest.mark.parametrize("bm,cap", ROW_TILES)
@pytest.mark.parametrize("xdt,wdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16)])
def test_dense_rows_are_bitwise_the_grouped_pre_combine_rows(dev, bm, cap,
                                                             xdt, wdt):
    """One choice per token at gate weight 1: the grouped kernel's output
    row is its pre-combine row (fmaf(1, h, 0) = h).  Dense expert_ffn on
    the dispatched buffer computes the same fmaf chains on every instance:
    the same bits, up to the cast to x's dtype that the grouped op takes."""
    M, F = 136, 200
    counts = [1, bm - 1, bm, bm + 1, 2 * bm + 3]
    E = len(counts)
    x, flat, _ = _routed(dev, counts, cap, M, k=1, seed=bm + 2)
    x = x.to(xdt)
    ws = [t.to(wdt) for t in _expert_weights(dev, E, M, F, True, seed=bm)]
    ones = torch.ones(flat.shape, device=dev)
    got = expert_ffn_grouped(x, flat, ones, *ws, cap=cap)
    pool = moe_dispatch(x, flat, E * cap).reshape(E, cap, M)
    dense = expert_ffn(pool, *ws).reshape(E * cap, M)
    kept = flat[:, 0] < E * cap
    rows = dense[flat[kept, 0].long()]
    assert torch.equal(got[kept], rows.to(xdt))


def test_expert_ffn_ragged_full_counts_are_the_dense_rows(dev):
    """Every count equal to c: the ragged form is the dense form on the
    same rows, bitwise (one mainloop, one fmaf chain per element)."""
    _, _, _, (w1, w3, w2), _ = _moe(dev)
    E, M = w1.shape[0], w1.shape[1]
    for c in (8, 160, 300):
        xb = torch.randn((E, 2, c, M), device=dev)
        counts = torch.full((E, 2), c, dtype=torch.int32, device=dev)
        got = expert_ffn_ragged(xb, counts, w1, w3, w2)
        dense = expert_ffn(xb.reshape(E, 2 * c, M), w1, w3, w2)
        assert torch.equal(got.reshape(E, 2 * c, M), dense), c


def test_expert_ffn_ragged_writes_dead_tiles_on_dirty_memory(dev):
    """The caching allocator hands the output back full of NaNs: rows past
    a count, whole tiles past it and groups of count 0 come out exactly 0
    (the kernel writes them); the rest equal a clean run bitwise."""
    _, _, _, (w1, w3, w2), _ = _moe(dev)
    E, M = w1.shape[0], w1.shape[1]
    c = 160
    xb = torch.randn((E, 1, c, M), device=dev)
    counts = torch.randint(0, c + 1, (E, 1), device=dev, dtype=torch.int32)
    counts[:3, 0] = torch.tensor([0, 5, 70], device=dev)
    want = expert_ffn_ragged(xb, counts, w1, w3, w2)
    torch.cuda.synchronize()
    dirty = torch.full((E * c, M), float("nan"), device=dev)
    del dirty                                    # back to the cache
    got = expert_ffn_ragged(xb, counts, w1, w3, w2)
    assert not bool(got.isnan().any())
    assert torch.equal(got, want)
    tail = torch.arange(c, device=dev)[None, None, :] >= counts[:, :, None]
    assert bool((got[tail] == 0).all())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_expert_ffn_ragged_vs_plain(dev, dtype, tol):
    _, _, _, (w1, w3, w2), _ = _moe(dev)
    E, M = w1.shape[0], w1.shape[1]
    c = 40
    xb = torch.randn((E, 2, c, M), device=dev).to(dtype)
    counts = torch.randint(0, c + 1, (E, 2), device=dev, dtype=torch.int32)
    counts[0] = torch.tensor([0, c])               # empty and full
    counts[1] = torch.tensor([5, 17])              # partial 16-row tiles
    n0 = expert_ffn_ragged.launches
    got = expert_ffn_ragged(xb, counts, w1, w3, w2)
    torch.cuda.synchronize()
    assert expert_ffn_ragged.launches == n0 + 1
    assert got.dtype == dtype
    torch.testing.assert_close(
        got.float(), expert_ffn_ragged_ref(xb, counts, w1, w3, w2).float(),
        rtol=tol, atol=tol)
    for e in range(E):
        for gi in range(2):
            n = int(counts[e, gi])
            assert (got[e, gi, n:] == 0).all(), (e, gi)


def test_new_kernels_raise_instead_of_falling_back(dev):
    """A CUDA tensor the kernel cannot take (float16, or operands on two
    devices) raises; no wrapper computes it with the plain version."""
    flat, w, n_slots = _slots(dev)
    x = torch.randn((flat.shape[0], 64), device=dev)
    with pytest.raises(TypeError, match="dtype"):
        moe_dispatch(x.half(), flat, n_slots)
    with pytest.raises(TypeError, match="dtype"):
        moe_combine(torch.zeros((n_slots, 64), device=dev).half(), flat, w)
    with pytest.raises(ValueError, match="devices"):
        moe_combine(torch.zeros((n_slots, 64), device=dev), flat.cpu(), w)
    _, _, _, (w1, w3, w2), _ = _moe(dev)
    E, M = w1.shape[0], w1.shape[1]
    with pytest.raises(TypeError, match="dtype"):
        expert_ffn(torch.zeros((E, 4, M), device=dev).half(), w1, w3, w2)
    with pytest.raises(ValueError, match="devices"):
        expert_ffn(torch.zeros((E, 4, M), device=dev), w1.cpu(), w3.cpu(),
                   w2.cpu())
    counts = torch.zeros((E, 1), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        expert_ffn_ragged(torch.zeros((E, 1, 4, M), device=dev).half(),
                          counts, w1, w3, w2)
    with pytest.raises(ValueError, match="counts"):
        expert_ffn_ragged(torch.zeros((E, 1, 4, M), device=dev),
                          counts.long(), w1, w3, w2)


@pytest.mark.parametrize("arch,schedule,chunks,wire", [
    ("qwen3-moe-30b-a3b", None, 1, "f32"),
    ("qwen3-moe-30b-a3b", "s1g", 1, "fp8_e4m3"),
    ("gpt2-moe", None, 1, "f32"),
    ("gpt2-moe", "s1", 2, "f32")])
def test_training_step_repeats_bitwise(dev, arch, schedule, chunks, wire):
    """The first step taken twice from the same parameters, AdamW state
    and batch gives torch.equal parameters and moments: the backward sums
    in fixed orders (combine's cotangent through the dispatch kernel), so
    no deterministic flag is needed."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.core.collectives import CommConfig
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.determinism import first_step_twice
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer
    assert not torch.are_deterministic_algorithms_enabled()
    cfg = get_config(arch).reduced()
    cfg = replace(cfg, moe=replace(cfg.moe, pipeline_chunks=chunks,
                                   comm=CommConfig(wire_dtype=wire)))
    tr = Trainer(Model(cfg, device=dev), AdamWConfig(lr=1e-3,
                                                     warmup_steps=2),
                 schedule=schedule)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                   global_batch=4)).tensors(0, dev)
    assert first_step_twice(tr, batch) == []


def _gpt2_trainer(dev, wire="fp8_e4m3"):
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.core.collectives import CommConfig
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer
    cfg = get_config("gpt2-moe").reduced()
    cfg = replace(cfg, moe=replace(cfg.moe, comm=CommConfig(wire_dtype=wire)))
    tr = Trainer(Model(cfg, device=dev), AdamWConfig(lr=1e-3, warmup_steps=2),
                 schedule="s1g")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                  global_batch=4))
    return tr, data


def _state(params, opt_state):
    from repro_torch.optim.adamw import leaves
    return (leaves(params) + leaves(opt_state["mu"])
            + leaves(opt_state["nu"]) + [opt_state["step"]])


@pytest.mark.parametrize("fault", [0.0, float("nan"), float("inf")])
def test_guarded_step_on_the_card(dev, fault):
    """Clean: the guarded step (lr_scale 1.0) is torch.equal to the plain
    step.  NaN / inf fault: the flag is up and parameters, moments and the
    step counter are torch.equal to what they were."""
    from repro_torch.train import make_guarded_train_step
    tr, data = _gpt2_trainer(dev)
    batch = data.tensors(0, dev)
    params, opt_state = tr.setup(torch.Generator(device=dev).manual_seed(0))
    params, opt_state, _ = tr.train_step(params, opt_state, batch)
    before = [t.detach().clone() for t in _state(params, opt_state)]
    step = make_guarded_train_step(tr.model, tr.opt_cfg, "s1g")
    params, opt_state, m = step(params, opt_state, data.tensors(1, dev), 1.0,
                                fault)
    if fault == 0.0:
        assert not bool(m["nonfinite"])
        p2, o2, m2 = tr.train_step(*tr.setup(torch.Generator(
            device=dev).manual_seed(0))[:2], batch)
        p2, o2, m2 = tr.train_step(p2, o2, data.tensors(1, dev))
        assert torch.equal(m["loss"], m2["loss"])
        assert all(torch.equal(a, b) for a, b in
                   zip(_state(params, opt_state), _state(p2, o2)))
    else:
        assert bool(m["nonfinite"]) and int(opt_state["step"]) == 1
        assert all(torch.equal(a, b) for a, b in
                   zip(_state(params, opt_state), before))


@pytest.mark.parametrize("factor", [0.0, 64.0])
def test_fp8_saturation_counts_on_the_card_are_the_cpus(dev, factor):
    from repro_torch.core import collectives as coll
    from repro_torch.runtime import (disable_fp8_monitor, enable_fp8_monitor,
                                     fp8_sat_counts, reset_fp8_counter)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((512, 768), generator=g)
    x[3] *= 1e3
    x[7, 11] = float("inf")
    comm = coll.CommConfig(wire_dtype="fp8_e4m3")
    counts = []
    enable_fp8_monitor()
    coll.set_fp8_sat_injection(factor)
    try:
        for t in (x, x.to(dev)):
            reset_fp8_counter()
            coll.wire_encode(t, comm)
            counts.append(fp8_sat_counts())
    finally:
        coll.set_fp8_sat_injection(0.0)
        disable_fp8_monitor()
        reset_fp8_counter()
    assert counts[0] == counts[1] and counts[0][1] == x.numel()


def test_restore_in_place_keeps_identity_and_requires_grad(dev, tmp_path):
    import os

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    g = torch.Generator(device=dev).manual_seed(0)
    live = {"w": torch.randn((64, 32), generator=g, device=dev),
            "b": torch.randn((32,), generator=g, device=dev).bfloat16(),
            "step": torch.tensor(3, dtype=torch.int32, device=dev)}
    live["w"].requires_grad_(True)
    saved = {k: t.detach().clone() for k, t in live.items()}
    path = save_checkpoint(os.path.join(tmp_path, "c.npz"), live, 3)
    ptrs = {k: t.data_ptr() for k, t in live.items()}
    with torch.no_grad():
        for t in live.values():
            t.zero_()
    tree, step = load_checkpoint(path, into=live)
    assert tree is live and step == 3 and live["w"].requires_grad
    assert {k: t.data_ptr() for k, t in live.items()} == ptrs
    for k, t in live.items():
        assert t.device.type == "cuda" and torch.equal(t, saved[k]), k


def test_serve_chaos_on_the_card(dev):
    """The CPU tests' chaos plan on reduced qwen3 on the card: request 1
    expired by its tick budget, request 2 evicted by the watchdog, the
    others torch-bitwise their fault-free streams (a delayed row rides
    along with a null page table), the pages balanced."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.runtime import FaultPlan
    from repro_torch.serve import Engine
    model = Model(get_config("qwen3-moe-30b-a3b").reduced(), device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, model.cfg.vocab_size, 6) for _ in range(4)]
    kw = dict(max_batch=4, max_len=64, prefix_cache=False,
              watchdog_rounds=5)

    def run(faults=None):
        eng = Engine(model, faults=faults, **kw)
        for p in prompts:
            eng.submit(p, 6)
        done = {c.rid: c for c in eng.run(params)}
        eng.pool.alloc_blocks.check()
        assert eng.pool.n_live == 0
        return done

    clean = run()
    done = run(FaultPlan.parse(
        "req_timeout@rid=1,ticks=3;req_delay@rid=2,rounds=999;"
        "alloc_starve@tick=1,hold=9999,rounds=4"))
    assert done[1].status == "expired" and "tick" in done[1].reason
    assert done[2].status == "evicted" and "watchdog" in done[2].reason
    for rid in (0, 3):
        assert done[rid].status == "ok"
        assert done[rid].tokens == clean[rid].tokens


@pytest.mark.parametrize("sched", ["s1", "s1g"])
def test_stage_trace_on_the_card(dev, sched):
    """A stage trace timed by CUDA events: the plan's stages in validated
    order with non-negative times, and the layer's output torch.equal
    before and after the timer."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.core import executor
    from repro_torch.core import plan as planlib
    from repro_torch.core.moe import apply_moe
    from repro_torch.obs.audit import _LayerHarness
    cfg = replace(get_config("gpt2-moe").reduced().moe, schedule=sched)
    h = _LayerHarness(cfg, 512, seed=1, device=dev)
    plan = planlib.build_plan(sched, h.info())
    with torch.no_grad():
        before, _ = apply_moe(h.x[None], h.params, cfg=cfg)
        st = h.trace(sched, iters=3, warmup=1)
        full, _ = executor.execute(plan, *h.args, h.info())
    assert [s.name for s in st.stages] == \
        [s.name for s in planlib.validate(plan)]
    assert st.total_s > 0 and all(s.measured_s >= 0 for s in st.stages)
    assert torch.equal(before[0], full)


def test_fit_card_model_on_the_card(dev):
    """The card's fits: both R^2 above the paper's 0.8, a positive
    startup, a rate under the f32 peak, and a model that keeps the data
    sheet's link betas."""
    from repro_torch.core.perfmodel import PEAK_FLOPS_F32, h100_model
    from repro_torch.launch.fit_perfmodel import (measure_card,
                                                  model_from_fits)
    fits = measure_card(dev)
    assert fits["flops"]["r2"] > 0.8 and fits["alpha"]["r2"] > 0.8, fits
    m = model_from_fits(fits, n_ep=4, n_esp=2, n_mp=2)
    sheet = h100_model(4, 2, 2)
    assert 0 < m.flops_per_s < PEAK_FLOPS_F32
    assert m.a2a_ep_esp.alpha > 0 and m.a2a_ep.beta == sheet.a2a_ep.beta
    assert m.ag_mp.alpha / m.ag_esp.alpha == \
        sheet.ag_mp.alpha / sheet.ag_esp.alpha


def test_measure_candidates_on_the_card(dev):
    """Every candidate timed finite by CUDA events; the global RNG (CPU
    and card), the step's ordinals and the fp8 monitor untouched; a
    second ``decide`` returns the cached decision and launches nothing."""
    from dataclasses import replace

    from repro_torch import runtime as trt
    from repro_torch.configs import get_config
    from repro_torch.core import autosched, collectives, moe
    from repro_torch.core.collectives import CommConfig
    from repro_torch.core.perfmodel import MoELayerShape
    cfg = replace(get_config("gpt2-moe").reduced().moe,
                  comm=CommConfig(wire_dtype="fp8_e4m3"))
    autosched.clear_cache()
    trt.enable_fp8_monitor()
    try:
        monitor = collectives._FP8_MONITOR
        calls = dict(moe._CALLS)
        rng = (torch.get_rng_state(), torch.cuda.get_rng_state(dev))
        measure = autosched.measure_candidates(cfg, tokens=512,
                                               d_model=cfg.d_model,
                                               device=dev)
        shape = MoELayerShape(B=1, L=512, M=cfg.d_model, H=cfg.d_ff,
                              E=cfg.n_experts, k=cfg.top_k,
                              f=cfg.capacity_factor)
        kw = dict(mode="measured", chunk_candidates=(1, 2),
                  wire_candidates=("fp8_e4m3", "bf16"), measure=measure)
        d = autosched.decide(shape, **kw)
        assert all(0 < t < float("inf") for _, t in d.times), d.times
        assert torch.equal(torch.get_rng_state(), rng[0])
        assert torch.equal(torch.cuda.get_rng_state(dev), rng[1])
        assert dict(moe._CALLS) == calls
        assert collectives._FP8_MONITOR is monitor
        assert trt.fp8_sat_counts() == (0, 0)
        before = expert_ffn_grouped.launches + moe_dispatch.launches
        assert autosched.decide(shape, **kw) is d
        assert expert_ffn_grouped.launches + moe_dispatch.launches == before
    finally:
        trt.disable_fp8_monitor()
        trt.reset_fp8_counter()
        autosched.clear_cache()
