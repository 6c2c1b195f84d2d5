"""The port stands alone: no file under ``src/repro_torch/`` and no line of
``chip_smoke.py`` imports JAX, the JAX package or ``ml_dtypes`` (the
card's machine has none of them), importing the port
builds nothing (the CUDA sources compile on the first CUDA call only), and
its entry points need a card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.join(os.path.dirname(__file__), "..")
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def _imported(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_no_jax_or_jax_package_imports():
    sources = _sources()
    assert len(sources) > 20
    bad = [(os.path.relpath(p, REPO), name) for p in sources
           for name in _imported(p)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_builds_nothing():
    code = """
import pkgutil, subprocess, sys
def refuse(*a, **k):
    raise AssertionError("a subprocess was started while importing")
subprocess.Popen = refuse
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    __import__(m.name)
from repro_torch.kernels import _build
assert not _build._libs, _build._libs
assert "torch.utils.cpp_extension" not in sys.modules
assert not any(n == "jax" or n.startswith(("jax.", "repro."))
               for n in sys.modules)
assert {"repro_torch.obs.sink", "repro_torch.obs.trace",
        "repro_torch.obs.audit", "repro_torch.serve.engine",
        "repro_torch.core.perfmodel", "repro_torch.core.autosched",
        "repro_torch.launch.fit_perfmodel"} <= set(sys.modules)
print("OK", len(list(pkgutil.walk_packages(repro_torch.__path__))))
"""
    r = _run(["-c", code])
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("OK")


def _run(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, *args], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_entry_points_refuse_to_run_without_a_card():
    """The launcher stops with a clear error rather than carry on on the
    CPU, and ``chip_smoke.py`` exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run on it")
    r = _run(["-m", "repro_torch.launch.serve", "--arch",
              "qwen3-moe-30b-a3b", "--reduced", "--smoke"])
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr
    r = _run(["-m", "repro_torch.launch.train", "--arch", "gpt2-moe",
              "--reduced", "--steps", "1"])
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr
    r = _run(["-m", "repro_torch.launch.fit_perfmodel"])
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr
    r = _run([os.path.join(REPO, "chip_smoke.py")])
    assert r.returncode != 0 and '"ok"' not in r.stdout, r.stdout


@pytest.mark.parametrize("arg,want", [
    (None, set(range(1, 19))), ("1,2,12", {1, 2, 12}), ("12", {1, 2, 12}),
    ("9", {1, 2, 7, 8, 9}), ("10", {1, 2, 4, 5, 6, 10}),
    ("11,3", {1, 2, 3, 4, 6, 11}), ("13", {1, 2, 13}), ("14", {1, 2, 14}),
    ("0", None), ("15", {1, 2, 15}), ("16", {1, 2, 16}),
    ("17", {1, 2, 17}), ("18", set(range(1, 19))), ("19", None),
    ("2,x", None), ("", None)],
    ids=["default", "1,2,12", "12", "9", "10", "11,3", "13", "14", "0",
         "15", "16", "17", "18", "19", "2,x", "empty"])
def test_chip_smoke_phase_selection(arg, want, capsys):
    """``chip_smoke.py --phases``: the named phases, those they need, and
    the card and the build; with no argument every phase (and the kernels
    line, phase 18, only then).  A bad selection exits 2 before anything
    runs.  No card needed: only the flag is parsed."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    argv = [] if arg is None else ["--phases", arg]
    if want is None:
        with pytest.raises(SystemExit) as exc:
            chip_smoke.parse_phases(argv)
        assert exc.value.code == 2
        assert "--phases" in capsys.readouterr().err
    else:
        assert chip_smoke.parse_phases(argv) == want


EXAMPLES = ("quickstart", "schedule_comparison", "serve_batched",
            "train_100m")


@pytest.mark.parametrize("name", EXAMPLES)
def test_the_examples_stand_alone_and_refuse_without_a_card(name):
    """Each example of ``repro_torch.examples`` is among the checked
    sources (no JAX, no JAX package) and, without a card and without
    ``--device cpu``, stops with the launchers' error before it runs."""
    import torch
    rel = os.path.join("examples", f"{name}.py")
    assert rel in {os.path.relpath(p, PORT) for p in _sources()}, rel
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would run on it")
    r = _run(["-m", f"repro_torch.examples.{name}"])
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr


@pytest.mark.parametrize("flag", [["--placement", "auto",
                                   "--rebalance-every", "2"]])
def test_train_launcher_refuses_flags_of_later_slices(flag, capsys):
    """The JAX launcher's flags that came with later slices of the port
    are taken, none refused: ``--placement auto --rebalance-every N`` runs
    (on one rank a placement changes nothing, as in JAX)."""
    from repro_torch.launch.train import main
    main(["--arch", "gpt2-moe", "--reduced", "--device", "cpu",
          "--steps", "3", "--seq", "32", "--batch", "2", *flag])
    out = capsys.readouterr()
    assert "later slice" not in out.err
    assert "placement auto" in out.out and "final loss" in out.out


@pytest.mark.parametrize("flag", [
    ["--wire-dtype", "auto"], ["--autosched", "analytic"],
    ["--autosched", "measured"]])
def test_train_launcher_takes_the_autoscheduler_flags(flag, capsys):
    """The autoscheduler's flags run (on the CPU when asked for) and the
    run reports its decision after the first step."""
    from repro_torch.core import autosched
    from repro_torch.launch.train import main
    autosched.clear_cache()
    main(["--arch", "gpt2-moe", "--reduced", "--device", "cpu", "--steps",
          "1", "--seq", "32", "--batch", "2", *flag])
    out = capsys.readouterr().out
    mode = flag[1] if flag[0] == "--autosched" else "analytic"
    assert f"autosched[{mode}] BxL=2x32" in out and "final loss" in out
    autosched.clear_cache()


def test_the_multi_rank_modules_stand_alone():
    """The multi-rank slice's modules are among the checked sources, and
    importing them starts no process group and no process."""
    sources = {os.path.relpath(p, PORT) for p in _sources()}
    for rel in ("parallel/__init__.py", "parallel/mesh.py",
                "parallel/sharding.py", "parallel/comm.py",
                "launch/mesh.py"):
        assert rel in sources, rel
    code = """
import subprocess, sys
def refuse(*a, **k):
    raise AssertionError("a subprocess was started while importing")
subprocess.Popen = refuse
import torch.distributed as dist
import repro_torch.parallel, repro_torch.parallel.comm
import repro_torch.launch.mesh, repro_torch.launch.train
assert not dist.is_initialized()
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro")
               for m in sys.modules), "a JAX module was imported"
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
