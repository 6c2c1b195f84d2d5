"""The port's training path on the CPU against the JAX package, on the same
numpy inputs and the JAX parameters (``params_from_jax``), the JAX side on
a one-device mesh: ``Model.loss`` and every parameter's gradient for
reduced qwen3-moe-30b-a3b, gpt2-moe and bert-moe (the port once more under
activation checkpointing); one ``adamw_update`` with the stacked-leaf
weight-decay mask; a 5-step ``Trainer`` run (losses, parameters and AdamW
state) for gpt2-moe and qwen3-moe-30b-a3b under ``auto``, gpt2-moe under
``s1`` with two chunks and qwen3-moe-30b-a3b under ``s1g`` with the fp8
wire; the synthetic batches; the autoscheduler decisions that let the
port run ``"auto"`` as ``s1g`` at training shapes; the first step taken
twice from one state on each of those four paths (bitwise); and the
embedding's gradient against ``jax.vjp`` (bitwise).

Tolerances: loss and CE 1e-5 relative (f32, two layers of the same math
summed in other orders); a gradient leaf within 1e-4 of its largest entry
(backward sums over tokens and experts amplify the forward's 1e-6
differences); routed-row counts exact.  AdamW alone: 1e-6 (the same
elementwise arithmetic).  Five training steps: losses 1e-4 relative and
parameters within 2e-5 absolute for gpt2-moe, 5e-5 for qwen3-moe-30b-a3b
(a few learning rates of 1e-3 times the normalized update's rounding: an
element whose gradient is near its rounding noise, or cancels between two
steps, takes a normalized step that differs by a few percent; in qwen3's
expert weights one or two elements of 98,304 land between 2e-5 and 4e-5).
With the fp8 wire the two runs drift apart: the frameworks' last-bit
differences put a few wire values on the other side of an e4m3 rounding
boundary (3 mantissa bits), which moves step 0's loss by 2.8e-5 and grows
from there.  So that case holds step 0's loss to 1e-4, the later losses to
2e-3 and grad norms to 2e-2 (measured 7.4e-4 and 6.3e-3), the parameters
to twice the steps' summed learning rate (the most Adam's normalized step
can part them) and the optimizer moments to 1e-1 of their largest entry
(measured 5.6e-2).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import autosched  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.core.collectives import CommConfig as JCommConfig  # noqa: E402
from repro.core.perfmodel import MoELayerShape  # noqa: E402
from repro.core.pipeline import clamp_chunks  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.parallel.mesh import ParallelDims, make_mesh  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax  # noqa: E402
from repro_torch.core import autosched as t_autosched  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.core.perfmodel import MoELayerShape as TShape  # noqa
from repro_torch.core.collectives import CommConfig as TCommConfig  # noqa
from repro_torch.convert import params_from_jax, to_numpy  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

DIMS = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
ARCHS = ("qwen3-moe-30b-a3b", "gpt2-moe", "bert-moe")


@pytest.fixture(autouse=True)
def fresh_sched_cache():
    autosched.clear_cache()
    t_autosched.clear_cache()
    yield
    autosched.clear_cache()
    t_autosched.clear_cache()


def _mesh():
    return make_mesh((1, 1), ("data", "model"))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def _close_tree(got, want, rel, atol_floor=0.0):
    want = dict(_paths(want))
    got = dict(_paths(got))
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        atol = max(rel * float(np.abs(w).max(initial=0.0)), atol_floor)
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol,
                                   err_msg=path)


@pytest.mark.parametrize("arch,remat", [(a, False) for a in ARCHS]
                         + [("qwen3-moe-30b-a3b", True)])
def test_loss_and_every_gradient_match_jax(arch, remat):
    jcfg = j_get_config(arch).reduced()
    tcfg = dataclasses.replace(get_config(arch).reduced(), remat=remat)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    batch = SyntheticLM(DataConfig(vocab_size=tcfg.vocab_size, seq_len=32,
                                   global_batch=2, seed=3)).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = _mesh()
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, mesh=mesh, dims=DIMS),
        has_aux=True))(jparams)

    tparams = params_from_jax(_np_tree(jparams), tcfg, device="cpu")
    flat = leaves(tparams)
    for t in flat:
        t.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    tloss, tm = Model(tcfg, device="cpu").loss(tparams, tbatch)
    grads = torch.autograd.grad(tloss, flat)
    it = iter(grads)

    def regrid(tree):
        return {k: regrid(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else next(it).numpy()

    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for key in ("ce", "aux", "ppl_proxy"):
        np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tm["expert_load"].numpy(),
                                  np.asarray(jm["expert_load"]))
    # a floor for leaves whose exact gradient is zero (the key bias: a
    # constant shift of every score of a query) and so is rounding noise
    _close_tree(regrid(tparams), _np_tree(jgrads), 1e-4, 1e-8)


def test_chunked_ce_is_forwards_ce(monkeypatch):
    """``loss``'s CE, taken in 4 checkpointed chunks here (the chunk limit
    lowered to 2**14 logits), is the CE of ``forward``'s logits, and its
    gradients are those of the one-chunk CE (f32: 1e-5 relative)."""
    from repro_torch.models import model as model_mod
    cfg = dataclasses.replace(get_config("gpt2-moe").reduced(), remat=True)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                   global_batch=2)).tensors(0, "cpu")
    logits, aux = model.forward(params, batch)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, batch["labels"][..., None]).mean()
    want = torch.autograd.grad(ce + aux["aux_loss"], flat)
    monkeypatch.setattr(model_mod, "CE_CHUNK_ELEMENTS", 1 << 14)
    loss, m = model.loss(params, batch)
    got = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(m["ce"].item(), ce.item(), rtol=1e-5)
    np.testing.assert_array_equal(m["expert_load"].numpy(),
                                  aux["expert_load"].numpy())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-5 * w.abs().max().item())


def test_adamw_update_matches_jax_with_stacked_decay_mask():
    rng = np.random.RandomState(0)
    shapes = {"final_norm": {"scale": (16,)},
              "run0": {"norm1": {"scale": (2, 16), "bias": (2, 16)},
                       "w": (2, 16, 8)},
              "embed": {"table": (32, 16)}}

    def rand(tree, s=1.0):
        return {k: rand(v, s) if isinstance(v, dict) else
                (s * rng.randn(*v)).astype(np.float32)
                for k, v in tree.items()}

    params, grads = rand(shapes), rand(shapes, 0.3)
    grads["final_norm"]["scale"][:] = 0.0
    grads["run0"]["norm1"]["scale"][:] = 0.0
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = j_adamw.adamw_init(jp)
    tp = _torch_tree(params)
    tstate = t_adamw.adamw_init(tp)
    for _ in range(2):
        jp, jstate, jom = j_adamw.adamw_update(
            jp, jax.tree.map(jnp.asarray, grads), jstate,
            j_adamw.AdamWConfig(**cfg))
        tom = t_adamw.adamw_update(tp, leaves(_torch_tree(grads)),
                                   tstate, t_adamw.AdamWConfig(**cfg))
    _close_tree(to_numpy(tp), _np_tree(jp), 1e-6, 1e-7)
    for key in ("mu", "nu"):
        _close_tree(to_numpy(tstate[key]), _np_tree(jstate[key]), 1e-6,
                    1e-9)
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tom[key]), float(jom[key]),
                                   rtol=1e-6)
    # zero gradient: only weight decay moves a leaf, and it moves the
    # stacked (n, D) norm scale but never the (D,) final norm
    tp = to_numpy(tp)
    np.testing.assert_array_equal(tp["final_norm"]["scale"],
                                  params["final_norm"]["scale"])
    assert not np.allclose(tp["run0"]["norm1"]["scale"],
                           params["run0"]["norm1"]["scale"])


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(v.copy()) for k, v in tree.items()}


def test_synthetic_batches_are_the_jax_packages():
    cfg = dict(vocab_size=97, seq_len=16, global_batch=3, seed=5)
    a, b = SyntheticLM(DataConfig(**cfg)), JSyntheticLM(JDataConfig(**cfg))
    for step in (0, 7):
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(a.batch(step)[key],
                                          b.batch(step)[key])
    t = a.tensors(7, "cpu")
    assert t["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(t["labels"].numpy(), a.batch(7)["labels"])


@pytest.mark.parametrize("arch,param_atol,schedule,moe_kw", [
    pytest.param("gpt2-moe", 2e-5, "auto", {}, id="gpt2-moe-2e-05"),
    pytest.param("qwen3-moe-30b-a3b", 5e-5, "auto", {},
                 id="qwen3-moe-30b-a3b-5e-05"),
    pytest.param("gpt2-moe", 2e-5, "s1", {"pipeline_chunks": 2},
                 id="gpt2-moe-s1-pipe2"),
    pytest.param("qwen3-moe-30b-a3b", 5e-5, "s1g", {"wire": "fp8_e4m3"},
                 id="qwen3-moe-30b-a3b-s1g-fp8")])
def test_trainer_five_steps_match_jax(arch, param_atol, schedule, moe_kw):
    """All at lr 1e-3, the launcher's default, at which full-width qwen3
    spikes on the card: the reduced run's curve, spike or not, is the JAX
    package's.  Besides ``auto`` (s1g), gpt2-moe under ``s1`` with two
    capacity chunks (dispatch, ``expert_ffn`` per chunk, combine) and qwen3
    under ``s1g`` with the fp8 wire (dispatch, the fp8 round trip and its
    re-encoding backward, ``expert_ffn_ragged``, combine)."""
    steps = 5
    jcfg = j_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    if moe_kw:
        kw = dict(moe_kw)
        wire = kw.pop("wire", "f32")
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, comm=JCommConfig(wire_dtype=wire), **kw))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, comm=TCommConfig(wire_dtype=wire), **kw))
    data_cfg = dict(vocab_size=tcfg.vocab_size, seq_len=32, global_batch=4)
    opt_cfg = dict(lr=1e-3, warmup_steps=2, total_steps=steps)
    mesh = _mesh()
    jtr = JTrainer(build_model(jcfg), mesh, DIMS,
                   j_adamw.AdamWConfig(**opt_cfg), schedule=schedule)
    jparams, jopt = jtr.setup(jax.random.PRNGKey(0))
    tparams = params_from_jax(_np_tree(jparams), tcfg, device="cpu")
    tr = Trainer(Model(tcfg, device="cpu"), t_adamw.AdamWConfig(**opt_cfg),
                 schedule=schedule)
    tparams, topt, thist = tr.run(tparams, t_adamw.adamw_init(tparams),
                                  SyntheticLM(DataConfig(**data_cfg)), steps,
                                  log_every=1)
    jparams, jopt, jhist = jtr.run(jparams, jopt,
                                   JSyntheticLM(JDataConfig(**data_cfg)),
                                   steps, log_every=1)
    assert [h["step"] for h in thist] == list(range(steps))
    # fp8: see the module docstring; step 0 still tells the fp8 run from
    # an f32 one (JAX's own f32 run starts 4.2e-4 away)
    fp8 = moe_kw.get("wire") == "fp8_e4m3"
    rtol = dict(loss=2e-3, ce=2e-3, grad_norm=2e-2, lr=1e-4) if fp8 \
        else dict(loss=1e-4, ce=1e-4, grad_norm=1e-4, lr=1e-4)
    np.testing.assert_allclose(thist[0]["loss"], jhist[0]["loss"],
                               rtol=1e-4)
    for key in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose([h[key] for h in thist],
                                   [h[key] for h in jhist], rtol=rtol[key])
    # The key bias's exact gradient is zero (it shifts every score of a
    # query by one constant), so both packages step it by Adam-normalized
    # rounding noise: it is held only to the steps' learning rates.
    # qwen3 has no qkv bias.
    got, want = to_numpy(tparams), _np_tree(jparams)
    lr_sum = sum(h["lr"] for h in jhist)
    runs = [r for r in got if r.startswith("run")]
    if tcfg.qkv_bias:
        for r in runs:
            np.testing.assert_allclose(got[r]["attn"].pop("bk"),
                                       want[r]["attn"].pop("bk"),
                                       rtol=0, atol=2 * lr_sum)
    _close_tree(got, want, 0.0, 2 * lr_sum if fp8 else param_atol)
    want = opt_state_from_jax(_np_tree(jopt), tcfg, device="cpu")
    assert int(topt["step"]) == int(want["step"]) == steps
    for key in ("mu", "nu"):
        got, ref = to_numpy(topt[key]), to_numpy(want[key])
        if tcfg.qkv_bias:
            for r in runs:
                got[r]["attn"].pop("bk"), ref[r]["attn"].pop("bk")
        _close_tree(got, ref, 1e-1 if fp8 else 2e-3, 1e-9)


# (B, L, arch): the training shapes of chip_smoke.py and the launcher, at
# full width and reduced
TRAIN_SHAPES = [(2, 1024, "qwen3-moe-30b-a3b"), (1, 2048, "qwen3-moe-30b-a3b"),
                (8, 512, "gpt2-moe"), (4, 256, "gpt2-moe"),
                (8, 1024, "gpt2-moe"), (2, 32, "qwen3-moe-30b-a3b-reduced"),
                (4, 32, "gpt2-moe-reduced")]


@pytest.mark.parametrize("B,L,arch", TRAIN_SHAPES)
def test_autosched_picks_s1g_at_training_shapes(B, L, arch):
    """``apply_moe(infer=False)`` asks ``autosched.decide`` exactly so at
    one rank; the answer must stay ``s1g`` with one chunk and an f32 wire,
    which the port's one-rank MoE layer runs for ``"auto"``: the port's
    own ``decide`` (the card's model) and ``resolve_schedule`` give it
    too."""
    name, reduced = arch.removesuffix("-reduced"), arch.endswith("-reduced")
    mcfg = j_get_config(name)
    mcfg = (mcfg.reduced() if reduced else mcfg).moe
    gate = mcfg.gate_config()
    s_local, cap = jmoe.shard_pool_capacity(B * L, 1, 1, gate, infer=False)
    shape = MoELayerShape(B=max(s_local // L, 1), L=min(L, s_local),
                          M=mcfg.d_model, H=mcfg.d_ff, E=mcfg.n_experts,
                          k=mcfg.top_k, f=mcfg.capacity_factor, n_mp=1,
                          n_esp=1, n_ep=1, infer=False)
    cands = tuple(sorted({clamp_chunks(cap, n)
                          for n in autosched.DEFAULT_CHUNKS}))
    d = autosched.decide(shape, chunk_candidates=cands)
    assert (d.schedule, d.n_chunks, d.wire_dtype) == ("s1g", 1, "f32"), d
    td = t_autosched.decide(TShape(**dataclasses.asdict(shape)),
                            chunk_candidates=cands)
    assert (td.schedule, td.n_chunks, td.wire_dtype) == ("s1g", 1, "f32")
    tcfg = get_config(name)
    tcfg = (tcfg.reduced() if reduced else tcfg).moe
    assert tmoe.resolve_schedule(tcfg, B=B, L=L) == ("s1g", 1, "f32")


@pytest.mark.parametrize("arch,schedule,chunks,wire", [
    ("qwen3-moe-30b-a3b", None, 1, "f32"),
    ("qwen3-moe-30b-a3b", "s1g", 1, "fp8_e4m3"),
    ("gpt2-moe", None, 1, "f32"),
    ("gpt2-moe", "s1", 2, "f32")])
def test_first_step_repeats_bitwise(arch, schedule, chunks, wire):
    """The first step taken twice from the same parameters, AdamW state
    and batch gives torch.equal parameters and moments on the CPU too:
    every scatter of the backward (the embedding's, combine's, the plain
    dispatch's) sums in a fixed order."""
    from repro_torch.launch.determinism import first_step_twice
    from repro_torch.train import Trainer as TTrainer
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, pipeline_chunks=chunks, comm=TCommConfig(wire_dtype=wire)))
    tr = TTrainer(Model(cfg, device="cpu"),
                  t_adamw.AdamWConfig(lr=1e-3, warmup_steps=2),
                  schedule=schedule)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                   global_batch=4)).tensors(0, "cpu")
    assert first_step_twice(tr, batch) == []


def test_embedding_gradient_is_jax_bits():
    """The embedding's backward sums a row's cotangents in ids order, as
    the transpose of JAX's gather does: bitwise ``jax.vjp``, with tokens
    that repeat up to 40 times."""
    from repro_torch.models.layers import embed
    rng = np.random.RandomState(3)
    table = rng.randn(16, 8).astype(np.float32)
    ids = rng.randint(0, 16, (4, 40)).astype(np.int32)
    ids[:, ::2] = 5
    g = (rng.randn(4, 40, 8) * 10.0 ** rng.randint(-3, 4, (4, 40, 1))
         ).astype(np.float32)
    _, vjp = jax.vjp(lambda t: t[jnp.asarray(ids)], jnp.asarray(table))
    want, = vjp(jnp.asarray(g))
    t = torch.from_numpy(table).requires_grad_(True)
    got, = torch.autograd.grad(embed({"table": t},
                                     torch.from_numpy(ids).long()), t,
                               torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
