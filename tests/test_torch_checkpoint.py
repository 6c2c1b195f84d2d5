"""The port's checkpoints (``repro_torch.checkpoint``): the JAX package's
npz format, written one leaf at a time.  f32, bf16 and int trees round-trip
bit-exactly, into new tensors and in place into live ones; a port file
loads in the JAX package's ``load_checkpoint`` with verification on, and
a JAX file in the port; a truncated file and a flipped bit raise
``CheckpointCorruptError`` (the latter naming the leaf); the store's
fallback, ``retain`` pruning and atomic write; save -> restore -> one more
train step is bitwise the step taken without the round trip; a restore
that fails leaves the live tensors untouched; and bf16 needs no
``ml_dtypes`` (the card's machine has none).  Every comparison is bitwise.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro_torch.checkpoint import (CheckpointCorruptError,  # noqa: E402
                                    CheckpointStore, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, leaves  # noqa: E402
from repro_torch.runtime import FaultPlan, RollbackManager  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tree(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    dt = DTYPES[dtype]
    return {"params": {"embed": torch.randn(8, 5, generator=g).to(dt),
                       "run0": {"w": torch.randn(2, 5, 3, generator=g).to(dt),
                                "norm": torch.randn(2, 5, generator=g)}},
            "opt_state": {"step": torch.tensor(7, dtype=torch.int32),
                          "ids": torch.arange(4)}}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _equal_trees(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_round_trip_is_bit_exact(tmp_path, dtype):
    """Into new CPU tensors and in place into live ones (identity and
    ``requires_grad`` kept); lists and tuples come back as saved."""
    tree = _tree(dtype)
    path = save_checkpoint(os.path.join(tmp_path, "ck.npz"), tree, step=3)
    out, step = load_checkpoint(path)
    assert step == 3
    _equal_trees(out, tree)
    live = _tree(dtype, seed=1)
    live["params"]["embed"].requires_grad_(True)
    ids = {k: id(t) for k, t in _flat(live).items()}
    got, step = load_checkpoint(path, into=live)
    assert got is live and step == 3
    _equal_trees(live, tree)
    assert {k: id(t) for k, t in _flat(live).items()} == ids
    assert live["params"]["embed"].requires_grad
    seq = {"a": [torch.ones(2), (torch.zeros(1), torch.tensor(2))]}
    out, _ = load_checkpoint(save_checkpoint(
        os.path.join(tmp_path, "seq.npz"), seq))
    assert isinstance(out["a"], list) and isinstance(out["a"][1], tuple)
    assert torch.equal(out["a"][1][1], seq["a"][1][1])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_checkpoint_loads_in_jax(tmp_path, dtype):
    tree = _tree(dtype)
    path = save_checkpoint(os.path.join(tmp_path, "port.npz"), tree, step=5)
    out, step = jckpt.load_checkpoint(path, verify=True)
    assert step == 5
    got, want = _flat(out), _flat(tree)
    assert got.keys() == want.keys()
    for k, t in want.items():
        a = np.asarray(got[k])
        assert str(a.dtype) == str(t.dtype).removeprefix("torch."), k
        bits = {2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize]
        ref = t.view({2: torch.int16, 4: torch.int32,
                      8: torch.int64}[t.element_size()]).numpy()
        np.testing.assert_array_equal(a.view(bits), ref.view(bits),
                                      err_msg=k)


@pytest.mark.parametrize("shape,dtype", [
    ((), np.int64), ((0,), np.float32), ((1,), np.uint8),
    ((3, 5), np.uint16), ((7, 129, 33), np.float32)])
def test_written_leaf_crc_is_zlibs(tmp_path, shape, dtype):
    """The manifest crc a member's write returns (the zip's crc of the
    member with the npy header's taken out) is ``zlib.crc32`` of the
    leaf's bytes, and ``np.load`` reads the member back."""
    import zipfile
    import zlib

    from repro_torch.checkpoint import ckpt
    a = np.random.RandomState(3).randint(0, 250, size=shape).astype(dtype)
    path = os.path.join(tmp_path, "one.zip")
    with zipfile.ZipFile(path, "w") as zf:
        got = ckpt._write(zf, "leaf", a)
    assert got == zlib.crc32(np.ascontiguousarray(a).tobytes())
    back = np.load(path)["leaf"]
    assert back.dtype == a.dtype and np.array_equal(back, a)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_jax_checkpoint_loads_in_port(tmp_path, dtype):
    rng = np.random.RandomState(0)
    jtree = {"params": {"w": jnp.asarray(rng.randn(4, 3), dtype=dtype),
                        "b": jnp.asarray(rng.randn(3), jnp.float32)},
             "opt": {"step": jnp.int32(2)},
             "seq": [jnp.arange(3), (jnp.float32(1.5),)]}
    path = os.path.join(tmp_path, "jax.npz")
    jckpt.save_checkpoint(path, jtree, step=9)
    out, step = load_checkpoint(path)
    assert step == 9 and out["params"]["w"].dtype == DTYPES[dtype]
    assert isinstance(out["seq"], list) and isinstance(out["seq"][1], tuple)
    for got, want in zip(
            [out["params"]["w"], out["params"]["b"], out["opt"]["step"],
             out["seq"][0], out["seq"][1][0]], jax.tree.leaves(
                [jtree["params"]["w"], jtree["params"]["b"],
                 jtree["opt"]["step"], jtree["seq"][0],
                 jtree["seq"][1][0]])):
        w = np.asarray(want)
        g = got.view(torch.int16).numpy() if got.dtype == torch.bfloat16 \
            else got.numpy()
        assert g.shape == w.shape and g.tobytes() == w.tobytes()
    live = {"params": {"w": torch.zeros(4, 3, dtype=DTYPES[dtype]),
                       "b": torch.zeros(3)},
            "opt": {"step": torch.tensor(0, dtype=torch.int32)},
            "seq": [torch.zeros(3, dtype=torch.int32), (torch.tensor(0.0),)]}
    load_checkpoint(path, into=live)
    assert torch.equal(live["params"]["w"], out["params"]["w"])
    assert int(live["opt"]["step"]) == 2


def test_truncated_and_bitflipped_files_raise(tmp_path):
    path = os.path.join(tmp_path, "ck.npz")
    save_checkpoint(path, {"w": torch.arange(64, dtype=torch.float32)}, 3)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(CheckpointCorruptError, match="unreadable"):
        load_checkpoint(path)
    save_checkpoint(path, {"params": {"embed": torch.arange(
        4096, dtype=torch.float32)}}, 1)
    FaultPlan.parse("ckpt_bitflip@save=1", seed=0).flip_bit(path)
    with pytest.raises(CheckpointCorruptError, match="params/embed"):
        load_checkpoint(path)


def test_manifest_catches_a_leaf_rewritten_with_a_valid_zip(tmp_path):
    """A leaf whose bytes changed but whose zip entry is intact (a
    rewritten member) fails the crc manifest, with its key named."""
    import zipfile
    path = os.path.join(tmp_path, "ck.npz")
    save_checkpoint(path, {"a": torch.ones(4), "b": torch.zeros(4)}, 1)
    bad = os.path.join(tmp_path, "bad.npz")
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(bad, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            if name == "b.npy":
                with zout.open(name, "w") as f:
                    np.lib.format.write_array(f, np.full(4, 2, np.float32))
            else:
                zout.writestr(name, data)
    with pytest.raises(CheckpointCorruptError, match=r"\['b'\]"):
        load_checkpoint(bad)
    load_checkpoint(bad, verify=False)


def test_store_fallback_retain_and_atomic_write(tmp_path):
    store = CheckpointStore(os.path.join(tmp_path, "run.npz"), retain=3)
    for s in (2, 4, 6):
        store.save({"w": torch.full((8,), float(s))}, s)
    FaultPlan.parse("ckpt_bitflip@save=1", seed=5).flip_bit(store.path_of(6))
    tree, step, path = store.restore()
    assert step == 4 and path.endswith("run.step00000004.npz")
    assert torch.equal(tree["w"], torch.full((8,), 4.0))
    store.save({"w": torch.ones(8)}, 8)
    assert store.steps() == [4, 6, 8]
    # a save that fails midway leaves no temporary file and the retained
    # files as they were
    with pytest.raises(TypeError):
        store.save({"w": torch.ones(8), "x": torch.ones(2).to(
            torch.float8_e4m3fnuz)}, 10)
    assert sorted(os.listdir(tmp_path)) == [
        "run.step00000004.npz", "run.step00000006.npz",
        "run.step00000008.npz"]
    assert store.restore()[1] == 8
    with pytest.raises(ValueError):
        CheckpointStore(str(tmp_path), retain=0)


def test_failed_restore_leaves_the_live_tensors_untouched(tmp_path):
    live = {"params": {"w": torch.randn(64, 64), "b": torch.randn(64)},
            "opt_state": {"step": torch.tensor(4, dtype=torch.int32)}}
    before = {k: t.clone() for k, t in _flat(live).items()}
    store = CheckpointStore(str(tmp_path), retain=2,
                            faults=FaultPlan.parse("ckpt_bitflip@save=1"))
    mgr = RollbackManager(store)
    mgr.snapshot({"w": torch.zeros(64, 64), "b": torch.zeros(64)},
                 {"step": torch.tensor(1, dtype=torch.int32)}, 1)
    assert mgr.rollback(3, live["params"], live["opt_state"]) is None
    with pytest.raises(ValueError, match="does not fit"):
        load_checkpoint(save_checkpoint(
            os.path.join(tmp_path, "other.npz"), {"params": {"w": torch.zeros(
                64, 64)}}), into=live)
    with pytest.raises(ValueError, match="'params/w'"):
        load_checkpoint(save_checkpoint(
            os.path.join(tmp_path, "shape.npz"),
            {"params": {"w": torch.zeros(32, 64), "b": torch.zeros(64)},
             "opt_state": {"step": torch.tensor(0, dtype=torch.int32)}}),
            into=live)
    for k, t in _flat(live).items():
        assert torch.equal(t, before[k]), k


def test_save_restore_then_one_more_step_is_bitwise(tmp_path):
    """Save after one step, restore in place into freshly initialised
    tensors through the rollback manager, take one more step: bitwise the
    second step taken without the round trip."""
    cfg = get_config("gpt2-moe").reduced()
    model = Model(cfg, device="cpu")
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2,
                                              total_steps=4))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=2))
    params = model.init(torch.Generator().manual_seed(0))
    opt = adamw_init(params)
    params, opt, _ = step(params, opt, data.tensors(0, "cpu"))
    mgr = RollbackManager(CheckpointStore(str(tmp_path)))
    mgr.snapshot(params, opt, 1)
    p2, o2 = model.init(torch.Generator().manual_seed(1)), None
    o2 = adamw_init(p2)
    p2, o2, restored = mgr.rollback(5, p2, o2)
    assert restored == 1 and int(o2["step"]) == 1
    a = step(params, opt, data.tensors(1, "cpu"))
    b = step(p2, o2, data.tensors(1, "cpu"))
    assert torch.equal(a[2]["loss"], b[2]["loss"])
    for x, y in zip(leaves(a[0]) + leaves(a[1]), leaves(b[0]) + leaves(b[1])):
        assert torch.equal(x, y)


def test_bf16_round_trip_without_ml_dtypes(tmp_path):
    """The card's machine has no jax and no ``ml_dtypes``: bf16 leaves
    must save and load through torch alone."""
    code = f"""
import sys
sys.modules["ml_dtypes"] = None
import torch
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
t = torch.randn(5, 7).bfloat16()
p = save_checkpoint({os.path.join(str(tmp_path), "b.npz")!r}, {{"t": t}}, 2)
out, step = load_checkpoint(p)
live = {{"t": torch.zeros(5, 7, dtype=torch.bfloat16)}}
load_checkpoint(p, into=live)
assert step == 2 and torch.equal(out["t"], t) and torch.equal(live["t"], t)
assert "jax" not in sys.modules
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "OK", r.stderr
