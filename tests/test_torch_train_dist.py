"""gpt2-moe training across ranks: the port's ``Trainer(mesh=, dims=)`` on
four gloo ranks of the merged ``(data=2, model=2)`` mesh against the JAX
package's ``Trainer`` on a 4-device (2, 2) host mesh, from the same JAX
parameters (``params_from_jax(..., mesh=, dims=)``: each rank's shards)
and the same synthetic batches (each rank's rows, ``sharded_batch``);
then the launcher's multi-rank path.

Tolerances: per step, loss within 1e-4 and gradient norm within 1e-3
relative (measured ~1e-6), the parameters after the first
step within 2e-5 absolute (as ``test_torch_train.py``'s five steps: a
learning rate of 5e-4 times the normalized update's rounding) except the
attention key bias, whose exact gradient is zero, within twice the
step's learning rate; so may be 0.01% of a leaf's elements (at least
one): an element whose gradient is at its rounding noise takes an
Adam-normalized first step g / (|g| + eps) that the two packages' last
bits move by a fraction of the learning rate (seen: one element of the
embedding's 131,072, 4.9e-5, under s2).  Both packages shard the dense
layers Megatron-style over ``model`` (JAX through GSPMD, the port through
``parallel.tensor``'s collectives; ``Model.param_specs`` is JAX's
``Model.specs``), so each rank holds its shards of attention, FFN and the
vocab-parallel embedding.  The capacity factor is the config's (1.2), so
each rank's pool drops its own rows in both packages.  The launcher's
``--multi-pod`` and ``--d-model`` (JAX's flags) last.
"""

import importlib.util
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from conftest import subprocess_env

pytestmark = [pytest.mark.multirank, pytest.mark.skipif(
    importlib.util.find_spec("jax") is None, reason="needs jax")]

SCHEDS = ("s1", "s2")
STEPS = 3
DATA = dict(seq_len=32, global_batch=8)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=STEPS)
ROOT = os.path.join(os.path.dirname(__file__), "..")

JAX_SCRIPT = r'''
import pickle, sys
import jax
import numpy as np
from repro.configs import get_config
from repro.data import DataConfig, SyntheticLM
from repro.models import build_model
from repro.optim import AdamWConfig
from repro.parallel.mesh import ParallelDims, make_mesh
from repro.train import Trainer

scheds, steps, data_kw, opt_kw = eval(sys.argv[2])
cfg = get_config("gpt2-moe").reduced()
mesh = make_mesh((2, 2), ("data", "model"))
dims = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
out = {}
for sched in scheds:
    tr = Trainer(build_model(cfg), mesh, dims, AdamWConfig(**opt_kw),
                 schedule=sched)
    params, opt = tr.setup(jax.random.PRNGKey(0))
    out["init"] = jax.tree.map(np.asarray, params)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, **data_kw))
    rows = []
    for step in range(steps):
        batch = data.sharded_batch(step, mesh, dims.batch_axes)
        params, opt, m = tr._step(params, opt, batch)
        rows.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
        if step == 0:
            out[sched + ":step1"] = jax.tree.map(np.asarray, params)
    out[sched] = rows
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''


def _train_rank(rank, ref):
    """One rank: the JAX parameters' shards trained ``STEPS`` steps under
    each schedule; returns the history and the shards after step 1."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax, to_numpy
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.train import Trainer
    cfg = get_config("gpt2-moe").reduced()
    mesh = make_mesh((2, 2), ("data", "model"))
    dims = dims_for(cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, **DATA))
    out = {}
    for sched in SCHEDS:
        tr = Trainer(Model(cfg, device="cpu"), AdamWConfig(**OPT),
                     schedule=sched, mesh=mesh, dims=dims)
        params = params_from_jax(ref["init"], cfg, device="cpu", mesh=mesh,
                                 dims=dims)
        opt = adamw_init(params)
        rows = []
        for step in range(STEPS):
            params, opt, m = tr.train_step(params, opt, tr.batch(data, step))
            rows.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                  "lr")})
            if step == 0:     # a copy: to_numpy shares the CPU storage
                out[sched + ":step1"] = _copy(to_numpy(params))
        out[sched] = rows
    return out


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    path = str(tmp_path_factory.mktemp("train_dist") / "jax.pkl")
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, path,
                        repr((SCHEDS, STEPS, DATA, OPT))],
                       env=subprocess_env(4), capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(path, "rb") as f:
        ref = pickle.load(f)
    ranks = spawn(_train_rank, 4, ref, backend="gloo", device="cpu",
                  threads=1, timeout=300)
    return ref, ranks


@pytest.mark.parametrize("sched", SCHEDS)
def test_four_ranks_train_as_the_jax_trainer(runs, sched):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models import Model
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.parallel.sharding import local_tree
    ref, ranks = runs
    cfg = get_config("gpt2-moe").reduced()
    model = Model(cfg, device="cpu")
    want_rows = ref[sched]
    lr0 = want_rows[0]["lr"]
    for rank, got in enumerate(ranks):
        for step, (g, w) in enumerate(zip(got[sched], want_rows)):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4,
                                       err_msg=f"rank {rank} step {step}")
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-3,
                                       err_msg=f"rank {rank} step {step}")
            np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        mesh = Mesh((2, 2), ("data", "model"), rank, groups=False)
        full = ref[sched + ":step1"]
        want = local_tree(full, model.param_specs(full, mesh, dims_for(cfg)),
                          mesh)
        mine = got[sched + ":step1"]
        for r in [k for k in mine if k.startswith("run")]:
            np.testing.assert_allclose(mine[r]["attn"].pop("bk"),
                                       want[r]["attn"].pop("bk"), rtol=0,
                                       atol=2 * lr0)

        def walk(a, b, path):
            if isinstance(a, dict):
                assert set(a) == set(b), path
                for k in a:
                    walk(a[k], b[k], f"{path}.{k}")
                return
            d = np.abs(a - np.asarray(b, np.float32))
            off = int((d > 2e-5).sum())
            assert off <= max(1, d.size // 10000), (rank, path, off, d.max())
            assert d.max() <= 2 * lr0, (rank, path, d.max())
        walk(mine, want, sched)


def test_ranks_hold_their_shards_and_replicas(runs):
    """The experts are split over the ranks (each holds a quarter of w1:
    half the experts, half the hidden dim), the embedding table over
    ``model`` (reduced gpt2-moe's vocabulary of 512 divides), each rank's
    block its ``local_shard`` of the table before training, and the
    ``data`` replicas of that block stay bitwise equal after training."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models import Model
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.parallel.sharding import P, local_shard
    ref, ranks = runs
    full = ref["init"]
    cfg = get_config("gpt2-moe").reduced()
    specs = Model(cfg, device="cpu").param_specs(
        full, Mesh((2, 2), ("data", "model"), 0, groups=False),
        dims_for(cfg))
    assert specs["embed"]["table"] == P(("model",), None)
    for sched in SCHEDS:
        for rank, got in enumerate(ranks):
            for r in [k for k in full if k.startswith("run")]:
                if "moe" in full[r]:
                    assert got[sched + ":step1"][r]["moe"]["w1"].size * 4 \
                        == full[r]["moe"]["w1"].size
            mesh = Mesh((2, 2), ("data", "model"), rank, groups=False)
            table = local_shard(full["embed"]["table"],
                                specs["embed"]["table"], mesh)
            assert got[sched + ":step1"]["embed"]["table"].shape \
                == table.shape == (cfg.vocab_size // 2, cfg.d_model)
        for rank in (2, 3):       # data=1 holds data=0's blocks, bitwise
            a = ranks[rank - 2][sched + ":step1"]["embed"]["table"]
            b = ranks[rank][sched + ":step1"]["embed"]["table"]
            assert np.array_equal(a, b), (sched, rank)


def test_the_launcher_trains_on_four_ranks():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gpt2-moe", "--reduced", "--device", "cpu", "--nproc", "4",
         "--mesh", "data=2,model=2", "--dist-backend", "gloo", "--steps",
         "2", "--seq", "32"], env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ranks: 4 on mesh {'data': 2, 'model': 2} over gloo" in r.stdout
    assert "final loss" in r.stdout
    assert r.stdout.count("final loss") == 1      # rank 0 alone prints


def test_the_launcher_trains_on_the_multi_pod_mesh():
    """``--multi-pod --nproc 8``: eight ranks laid out as (pod, data,
    model) = (2, 2, 2), pod pure data parallel (``production_dims(
    multi_pod=True)``), one step."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gpt2-moe", "--reduced", "--device", "cpu", "--nproc", "8",
         "--multi-pod", "--dist-backend", "gloo", "--steps", "1", "--seq",
         "32", "--batch", "8"], env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert ("ranks: 8 on mesh {'pod': 2, 'data': 2, 'model': 2} over gloo"
            in r.stdout), r.stdout
    assert r.stdout.count("final loss") == 1


def test_the_launchers_d_model_is_jaxs(monkeypatch, capsys):
    """``--reduced --d-model 128`` builds JAX's ``reduced(n_layers=2,
    d_model=128)`` (the widths, heads and experts compared)."""
    from repro.configs import get_config as j_get_config
    from repro_torch.launch import train as launch_train
    seen = []

    class Spy(launch_train.Model):
        def __init__(self, cfg, *a, **kw):
            seen.append(cfg)
            super().__init__(cfg, *a, **kw)
    monkeypatch.setattr(launch_train, "Model", Spy)
    launch_train.main(["--arch", "qwen3-moe-30b-a3b", "--reduced",
                       "--d-model", "128", "--device", "cpu", "--steps",
                       "1", "--seq", "16", "--batch", "2"])
    assert "final loss" in capsys.readouterr().out
    want = j_get_config("qwen3-moe-30b-a3b").reduced(n_layers=2,
                                                     d_model=128)
    (got,) = seen
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("d_model", "d_ff", "n_experts", "top_k"):
        assert getattr(got.moe, f) == getattr(want.moe, f), f
    assert got.d_model == 128


@pytest.mark.parametrize("flags", [
    ["--autosched", "measured"], ["--profile"], [],
    ["--dist-backend", "nccl"]],
    ids=["measured", "profile", "no-backend", "nccl-without-cards"])
def test_the_launcher_refuses_what_runs_on_one_rank(flags, capsys,
                                                     monkeypatch):
    """``--profile`` on the CPU exits 2 as on one rank (it measures the
    card); gloo is never picked silently (no backend: exit 2), and nccl
    with more ranks than cards (or on the CPU) refuses to start.  All
    before a rank is spawned.  ``--autosched measured`` no longer runs on
    one rank only: across ranks the launcher spawns its ranks with it
    (``test_torch_autosched_dist.py`` runs them)."""
    from repro_torch.launch import train as launch_train
    extra = [] if "--dist-backend" in flags or flags == [] else [
        "--dist-backend", "gloo"]
    if flags == ["--autosched", "measured"]:
        spawned = []
        monkeypatch.setattr(launch_train, "spawn",
                            lambda fn, n, args, *a, **kw:
                            spawned.append((n, args.autosched)))
        launch_train.main(["--arch", "gpt2-moe", "--reduced", "--device",
                           "cpu", "--nproc", "2", "--steps", "1", *extra,
                           *flags])
        assert spawned == [(2, "measured")]
        return
    with pytest.raises(SystemExit) as e:
        launch_train.main(["--arch", "gpt2-moe", "--reduced", "--device",
                           "cpu", "--nproc", "2", "--steps", "1", *extra,
                           *flags])
    assert e.value.code == 2
    err = capsys.readouterr().err
    if flags == ["--profile"]:
        assert "needs --device cuda" in err, err
    elif flags:
        assert "nccl" in err, err
    else:
        assert "--dist-backend" in err, err
