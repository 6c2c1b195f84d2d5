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


@pytest.mark.parametrize("flag", [["--placement", "auto"]])
def test_train_launcher_refuses_flags_of_later_slices(flag, capsys):
    """A JAX launcher flag the port does not run yet is an error, never a
    silent no-op (checked before any device or model is touched)."""
    from repro_torch.launch.train import main
    with pytest.raises(SystemExit) as exc:
        main(["--arch", "gpt2-moe", "--reduced", "--device", "cpu",
              "--steps", "1", *flag])
    assert exc.value.code == 2
    assert "later slice" in capsys.readouterr().err


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
