"""The five configs whose block kinds the port runs (yi-9b,
mistral-nemo-12b, qwen1.5-0.5b, command-r-35b, llama4-scout-17b-a16e)
against the JAX package on the CPU: each config's fields, then
``Model.loss`` and every parameter's gradient from the JAX parameters
(``params_from_jax``), and llama4's routed rows per expert; the train
launcher on a dense and an MoE arch (``--reduced --device cpu``) writes
the events the JAX launcher writes with the same flags (``expert_load``
beside each logged step of the MoE run).

Each config is reduced the same way on both sides, keeping the trait it
brings: llama4 to 4 layers, so that the fourth is a NoPE ``moe_full``
layer beside three chunked local ones (its chunk cut to 64 tokens);
command-r and llama4 to 2 kv heads of 4 (GQA; ``reduced()`` makes them
4/4); mistral-nemo to a head_dim of 96, so that ``n_heads * head_dim``
(384) is not ``d_model`` (256).  The batch is 2 x 80 tokens, longer than
llama4's reduced chunk.

Tolerances are ``test_torch_train.py``'s: loss and CE 1e-5 relative, a
gradient leaf within 1e-4 of its largest entry, routed rows exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import autosched  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.parallel.mesh import ParallelDims, make_mesh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import autosched as t_autosched  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402

DIMS = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
ARCHS = ("yi-9b", "mistral-nemo-12b", "qwen1.5-0.5b", "command-r-35b",
         "llama4-scout-17b-a16e")
SEQ = 80


def reduce(cfg):
    """``cfg`` (either package's) cut to test size, keeping its trait."""
    if cfg.name.startswith("llama4"):
        return dataclasses.replace(cfg.reduced(n_layers=4), n_kv_heads=2)
    if cfg.name.startswith("command-r"):
        return dataclasses.replace(cfg.reduced(), n_kv_heads=2)
    if cfg.name.startswith("mistral-nemo"):
        return dataclasses.replace(cfg.reduced(), head_dim=96)
    return cfg.reduced()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: its tensors here are small,
    and beside other test processes a thread pool per process only
    contends for the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_sched_cache():
    autosched.clear_cache()
    t_autosched.clear_cache()
    yield
    autosched.clear_cache()
    t_autosched.clear_cache()


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_jaxs(arch):
    j, t = j_get_config(arch), get_config(arch)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    jm, tm = jd.pop("moe"), td.pop("moe")
    assert jd == td
    assert (jm is None) == (tm is None)
    if jm is not None:
        assert set(jm) == set(tm)
        for k in jm:
            assert tm[k] == jm[k], k
    assert t.runs() == j.runs()
    assert reduce(t).runs() == reduce(j).runs()


def test_reductions_keep_each_trait():
    cfgs = {a: reduce(get_config(a)) for a in ARCHS}
    l4 = cfgs["llama4-scout-17b-a16e"]
    assert l4.runs() == [("moe", 3), ("moe_full", 1)]
    assert l4.attn_chunk < SEQ and l4.moe.top_k == 1 \
        and l4.moe.n_shared_experts == 1
    for a in ("llama4-scout-17b-a16e", "command-r-35b"):
        assert cfgs[a].n_heads == 2 * cfgs[a].n_kv_heads
    nemo = cfgs["mistral-nemo-12b"]
    assert nemo.n_heads * nemo.hd != nemo.d_model
    cr = cfgs["command-r-35b"]
    assert cr.parallel_block and cr.tie_embeddings and cr.logit_scale != 1
    assert cfgs["qwen1.5-0.5b"].qkv_bias


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    jcfg = reduce(j_get_config(arch))
    tcfg = reduce(get_config(arch))
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    batch = SyntheticLM(DataConfig(vocab_size=tcfg.vocab_size, seq_len=SEQ,
                                   global_batch=2, seed=3)).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = make_mesh((1, 1), ("data", "model"))
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, mesh=mesh, dims=DIMS),
        has_aux=True))(jparams)

    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    flat = leaves(tparams)
    for t in flat:
        t.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    tloss, tm = Model(tcfg, device="cpu").loss(tparams, tbatch)
    grads = iter(torch.autograd.grad(tloss, flat))

    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for key in ("ce", "aux", "ppl_proxy"):
        np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tm["expert_load"].numpy(),
                                  np.asarray(jm["expert_load"]))
    if tcfg.moe is not None:
        assert tm["expert_load"].shape == (tcfg.moe.n_experts,)
        assert float(tm["expert_load"].sum()) > 0

    def walk(tree, jtree, path):
        if isinstance(tree, dict):
            assert set(tree) == set(jtree), path
            for k in tree:
                walk(tree[k], jtree[k], f"{path}.{k}")
            return
        w = np.asarray(jtree, np.float32)
        atol = 1e-4 * float(np.abs(w).max(initial=0.0))
        np.testing.assert_allclose(next(grads).numpy(), w, rtol=0,
                                   atol=atol, err_msg=path)

    walk(tparams, jax.tree.map(np.asarray, jgrads), arch)
    assert ("lm_head" in tparams) == (not tcfg.tie_embeddings)


#: the events the JAX train launcher writes with ``LAUNCH_FLAGS``: an MoE
#: arch streams the load EMA beside each logged step once it is live, a
#: dense arch has no plan stages to trace and no load to stream
JAX_EVENTS = {"moe": ["meta", "autosched_decision", "train_step",
                      "expert_load", "train_step", "expert_load",
                      "stage_trace"],
              "dense": ["meta", "train_step", "train_step"]}
LAUNCH_FLAGS = ["--reduced", "--steps", "3", "--seq", "32", "--batch", "2"]


@pytest.mark.parametrize("arch", ["command-r-35b", "llama4-scout-17b-a16e"])
def test_train_launcher_writes_jaxs_events(arch, tmp_path, capsys):
    import json
    import os

    from repro_torch.launch.train import main
    from repro_torch.obs.sink import read_events
    mdir, log = os.path.join(tmp_path, "m"), os.path.join(tmp_path, "l.json")
    main(["--arch", arch, "--device", "cpu", *LAUNCH_FLAGS, "--metrics-dir",
          mdir, "--trace", "--log-json", log])
    cap = capsys.readouterr()
    assert "final loss" in cap.out
    rec = json.load(open(log))
    kind = "dense" if get_config(arch).moe is None else "moe"
    assert [e["event"] for e in read_events(rec["obs"]["metrics_files"])] \
        == JAX_EVENTS[kind]
    assert ("--trace: dense arch" in cap.out + cap.err) == (kind == "dense")
