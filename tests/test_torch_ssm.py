"""The port's recurrent cells (``repro_torch/models/ssm.py``) against the JAX
package's (``repro/models/ssm.py``) on the CPU: Mamba, mLSTM and sLSTM at
test size, on the same parameters (JAX's ``init_*``, as numpy) and the
same inputs (numpy from a seed).

For each cell: the training output and the gradient of every parameter
and of the input against ``jax.grad`` of the same weighted sum; the
decode outputs and states, token by token, against JAX's decode; the
decode outputs against the port's own chunked forward; the init's
constant leaves equal to JAX's and its random leaves' standard deviations
within 10% of JAX's.  L = 80 makes the chunk rules halve: mLSTM's 64 to
16 (five chunks), Mamba's 32 to 16 (and its default 128 gives one chunk
of 80, whose scan recursion meets odd lengths); the associative scan and
the running maximum are also held to JAX's on ties, forward and backward.

Tolerances: port against JAX, max |d| <= 1e-5 * max |want| (outputs and
states); gradients within 1e-4 of the leaf's largest entry, as in
``test_torch_train.py``; decode against the forward, JAX's own
``tests/test_ssm.py`` bounds (rtol / atol 2e-4 / 2e-5 Mamba, 3e-4 / 3e-5
mLSTM, 2e-5 / 2e-6 sLSTM).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

B, L = 2, 80
DECODE_TOL = {"mamba": (2e-4, 2e-5), "mlstm": (3e-4, 3e-5),
              "slstm": (2e-5, 2e-6)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: its tensors here are small,
    and beside other test processes a thread pool per process only
    contends for the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cells(mamba_chunk=128):
    """(name, JAX config, port config, JAX module functions, port's)."""
    return {
        "mamba": (jssm.MambaConfig(d_model=32, d_inner=64, d_state=8,
                                   chunk=mamba_chunk),
                  ssm.MambaConfig(d_model=32, d_inner=64, d_state=8,
                                  chunk=mamba_chunk),
                  (jssm.init_mamba, jssm.apply_mamba, jssm.init_mamba_state),
                  (ssm.apply_mamba, ssm.init_mamba_state)),
        "mlstm": (jssm.MLSTMConfig(d_model=32, n_heads=2),
                  ssm.MLSTMConfig(d_model=32, n_heads=2),
                  (jssm.init_mlstm, jssm.apply_mlstm, jssm.init_mlstm_state),
                  (ssm.apply_mlstm, ssm.init_mlstm_state)),
        "slstm": (jssm.SLSTMConfig(d_model=32, n_heads=4),
                  ssm.SLSTMConfig(d_model=32, n_heads=4),
                  (jssm.init_slstm, jssm.apply_slstm, jssm.init_slstm_state),
                  (ssm.apply_slstm, ssm.init_slstm_state)),
    }


CASES = [("mamba", 128), ("mamba", 32), ("mlstm", 128), ("slstm", 128)]


def setup(name, chunk, seed=0):
    jcfg, tcfg, (jinit, japply, jstate), (tapply, tstate) = \
        cells(chunk)[name]
    jp = jinit(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed + 1)
    x = rng.randn(B, L, jcfg.d_model).astype(np.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, tcfg, japply, jstate, tapply, tstate, jp, tp, x


def close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rel * scale, f"{what}: max|d| {err:.3e} > {rel} * {scale:.3e}"


@pytest.mark.parametrize("name,chunk", CASES)
def test_training_output_and_every_gradient_match_jax(name, chunk):
    jcfg, tcfg, japply, _, tapply, _, jp, tp, x = setup(name, chunk)
    w = np.random.RandomState(7).randn(B, L, jcfg.d_model).astype(
        np.float32)

    def jloss(p, xx):
        y = japply(p, jcfg, xx)
        return jnp.sum(y * w), y

    (_, want), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))

    tx = torch.from_numpy(x).requires_grad_(True)
    for t in tp.values():
        t.requires_grad_(True)
    got = tapply(tp, tcfg, tx)
    close(got.detach(), want, what=f"{name} forward")
    names = list(tp)
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                                [tp[k] for k in names] + [tx])
    for k, g in zip(names + ["x"], grads):
        want_g = np.asarray(jgx if k == "x" else jg[k], np.float32)
        atol = 1e-4 * float(np.abs(want_g).max())
        np.testing.assert_allclose(g.numpy(), want_g, rtol=0, atol=atol,
                                   err_msg=f"{name}.{k}")


@pytest.mark.parametrize("name", ["mamba", "mlstm", "slstm"])
def test_decode_matches_jax_and_the_chunked_forward(name):
    chunk = 32 if name == "mamba" else 128
    jcfg, tcfg, japply, jstate, tapply, tstate, jp, tp, x = setup(name,
                                                                  chunk)
    jst = jstate(jcfg, B)
    jstep = jax.jit(lambda p, xt, s: japply(p, jcfg, xt, state=s))
    st = tstate(tcfg, B, device="cpu")
    ys = []
    for t in range(L):
        jy, jst = jstep(jp, jnp.asarray(x[:, t:t + 1]), jst)
        with torch.no_grad():
            y, st = tapply(tp, tcfg, torch.from_numpy(x[:, t:t + 1]),
                           state=st)
        close(y, jy, what=f"{name} decode output, token {t}")
        assert len(st) == len(jst)
        for i, (a, b) in enumerate(zip(st, jst)):
            close(a, b, what=f"{name} decode state {i}, token {t}")
        ys.append(y[:, 0].numpy())
    with torch.no_grad():
        fwd = tapply(tp, tcfg, torch.from_numpy(x)).numpy()
    rtol, atol = DECODE_TOL[name]
    np.testing.assert_allclose(np.stack(ys, 1), fwd, rtol=rtol, atol=atol)


#: each init's keys in JAX's order
ORDER = {"mamba": ("in_proj", "conv_w", "conv_b", "w_bc", "w_dt", "b_dt",
                   "a_log", "d_skip", "out_proj"),
         "mlstm": ("up_proj", "wq", "wk", "wv", "w_if", "b_i", "b_f",
                   "down_proj"),
         "slstm": ("w_x", "r_h", "bias", "out_proj")}
#: leaves set to constants by the init (JAX's values exactly)
CONSTANT = {"mamba": ("conv_b", "a_log", "d_skip"), "mlstm": ("b_i", "b_f"),
            "slstm": ("bias",)}


def test_init_matches_jaxs_constants_and_spreads():
    big = {"mamba": (jssm.MambaConfig(d_model=128, d_inner=256, d_state=16),
                     ssm.MambaConfig(d_model=128, d_inner=256, d_state=16),
                     jssm.init_mamba, ssm.init_mamba),
           "mlstm": (jssm.MLSTMConfig(d_model=128, n_heads=4),
                     ssm.MLSTMConfig(d_model=128, n_heads=4),
                     jssm.init_mlstm, ssm.init_mlstm),
           "slstm": (jssm.SLSTMConfig(d_model=128, n_heads=4),
                     ssm.SLSTMConfig(d_model=128, n_heads=4),
                     jssm.init_slstm, ssm.init_slstm)}
    for name, (jcfg, tcfg, jinit, tinit) in big.items():
        jp = jinit(jax.random.PRNGKey(0), jcfg)
        tp = tinit(torch.Generator().manual_seed(0), tcfg)
        assert tuple(tp) == ORDER[name] and set(jp) == set(tp), name
        for k, v in tp.items():
            want = np.asarray(jp[k])
            assert tuple(v.shape) == want.shape and v.dtype == torch.float32
            if k in CONSTANT[name]:
                np.testing.assert_array_equal(v.numpy(), want,
                                              err_msg=f"{name}.{k}")
            else:
                ratio = float(v.std()) / float(want.std())
                assert abs(ratio - 1) <= 0.1, (name, k, ratio)
    # b_dt: the inverse softplus of a dt in [1e-3, 1e-1]
    b_dt = ssm.init_mamba(torch.Generator().manual_seed(1),
                          big["mamba"][1])["b_dt"]
    dt = torch.nn.functional.softplus(b_dt)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-4) and \
        float(dt.max()) <= 1e-1 * (1 + 1e-4), b_dt


def test_scans_and_their_ties_match_jax():
    """The associative scan and the running maximum, forward and backward,
    on lengths that meet both branches of the recursion, and on ties
    (where ``torch.cummax`` and ``torch.clamp`` would route the gradient
    otherwise)."""
    from jax import lax
    rng = np.random.RandomState(3)
    for n in (1, 2, 5, 16, 80):
        a = rng.rand(2, n, 3).astype(np.float32) + 0.5
        b = rng.randn(2, n, 3).astype(np.float32)
        jpa, jph = jax.jit(lambda a, b: lax.associative_scan(
            lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1]), (a, b),
            axis=1))(a, b)
        pa, ph = ssm.associative_scan(ssm._mamba_comb, (torch.from_numpy(a),
                                                        torch.from_numpy(b)),
                                      1)
        np.testing.assert_array_equal(pa.numpy(), np.asarray(jpa))
        close(ph, jph, what=f"scan n={n}")
    ties = np.array([[1., 3., 3., 2., 3., 5., 5., 0., 5., 4., 5.]],
                    np.float32)
    w = np.arange(1, ties.shape[1] + 1, dtype=np.float32)
    jv, jg = jax.value_and_grad(
        lambda v: jnp.sum(lax.cummax(v, axis=1) * w))(jnp.asarray(ties))
    t = torch.from_numpy(ties).requires_grad_(True)
    v = (ssm.cummax(t, 1) * torch.from_numpy(w)).sum()
    (g,) = torch.autograd.grad(v, t)
    assert v.item() == float(jv)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    tc = torch.from_numpy(ties).requires_grad_(True)
    (gc,) = torch.autograd.grad((torch.cummax(tc, 1).values
                                 * torch.from_numpy(w)).sum(), tc)
    assert not np.array_equal(gc.numpy(), np.asarray(jg))
    # maximum against a tie, and |x| at 0
    a = np.array([1., 2., 1e-6, 0.], np.float32)
    c = np.array([1., 1., 1e-6, 0.], np.float32)
    jga, jgc = jax.grad(lambda a, c: jnp.sum(jnp.maximum(jnp.abs(a), c)),
                        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(c))
    ta = torch.from_numpy(a).requires_grad_(True)
    tc = torch.from_numpy(c).requires_grad_(True)
    ga, gc = torch.autograd.grad(torch.maximum(ssm._abs(ta), tc).sum(),
                                 (ta, tc))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(jga))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(jgc))


def _canon(spec):
    return tuple(None if e is None else ((e,) if isinstance(e, str)
                                         else tuple(e)) for e in spec)


@pytest.mark.parametrize("shape", [(2, 2), (1, 3)], ids=["2x2", "1x3"])
def test_specs_are_jaxs(shape):
    """Each cell's specs are JAX's (the JAX functions read only
    ``mesh.shape``, so both take the port's layout-only ``Mesh``): on
    (2, 2) d_inner splits over ``model``, on (1, 3) it does not divide."""
    from repro_torch.parallel.mesh import Mesh
    mesh = Mesh(shape, ("data", "model"), 0, groups=False)
    for name, (jcfg, tcfg, _, _) in cells().items():
        jspec = getattr(jssm, f"{name}_specs")(mesh, ("model",), jcfg)
        tspec = getattr(ssm, f"{name}_specs")(mesh, ("model",), tcfg)
        assert {k: _canon(v) for k, v in tspec.items()} == \
            {k: _canon(v) for k, v in jspec.items()}, name


@pytest.mark.parametrize("name", ["mamba", "mlstm", "slstm"])
def test_bf16_cells_promote_as_jax(name):
    """A bf16 model (the dry run's dtype): its f32 states meet bf16
    products (Mamba's ``C``, sLSTM's ``r_h``), which JAX's einsums promote
    to f32 and the port's cast so.  The training output and ten decode
    steps' outputs and states against JAX's in bf16, within 3e-2 of the
    largest entry (bf16's 8 bits, rounded in other places)."""
    jcfg, tcfg, (jinit, japply, jstate), (tapply, tstate) = cells()[name]
    jp = jinit(jax.random.PRNGKey(3), jcfg, jnp.bfloat16)
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in jp.items()}
    x = np.random.RandomState(4).randn(B, 16, jcfg.d_model).astype(
        np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    japply = jax.jit(japply, static_argnums=1)
    close(tapply(tp, tcfg, tx).float(), np.asarray(
        japply(jp, jcfg, jx), np.float32), 3e-2, f"{name} bf16 forward")
    if name == "mamba":
        js, ts = jstate(jcfg, B, jnp.bfloat16), tstate(
            tcfg, B, torch.bfloat16, "cpu")
    else:
        js, ts = jstate(jcfg, B), tstate(tcfg, B, "cpu")
    for t in range(10):
        jy, js = japply(jp, jcfg, jx[:, t:t + 1], state=js)
        ty, ts = tapply(tp, tcfg, tx[:, t:t + 1], state=ts)
        close(ty.float(), np.asarray(jy, np.float32), 3e-2,
              f"{name} bf16 decode {t}")
        for a, b in zip(ts, js):
            close(a.float(), np.asarray(b, np.float32), 3e-2,
                  f"{name} bf16 state {t}")
