"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers: a source that
includes ``torch/extension.h`` takes minutes to compile, a plain one
seconds).  ``build_all`` starts one ``nvcc`` per source, all at once, and
waits for them; ``library(name)`` builds on first call and returns the
loaded ``ctypes.CDLL``.  Libraries are named by a hash of their source, the
shared headers and the flags, so an edited source or header is rebuilt and
an unchanged one is reused.

Outputs go to ``build/repro_torch/`` at the repository root (git-ignored),
created on first build.  Importing this module builds nothing and imports
no compiler machinery; a failed build raises, and nothing falls back to the
plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("rmsnorm", "expert_ffn_grouped", "flash_attention", "moe_dispatch",
           "expert_ffn")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc``,
    else ``/usr/local/cuda/bin/nvcc``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME/bin "
                       "and /usr/local/cuda/bin): the port's CUDA kernels "
                       "cannot be built")


def _target(name: str) -> Path:
    """The library path of ``csrc/<name>.cu``, tagged by a hash of the source,
    every shared header (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every source in ``names`` that has no up-to-date library,
    one ``nvcc`` process per source, all started together.  Returns
    ``{name: ptxas/nvcc log}`` for the sources compiled by this call and
    raises ``RuntimeError`` with the compiler output if any build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = {n: _target(n) for n in names if not _target(n).exists()}
        if not todo:
            return {}
        nvcc = nvcc_path()
        procs = {}
        for name, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(name)
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[n] for n in failed))
        return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


#: dtype codes of the C interfaces
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t, what: str) -> int:
    code = DTYPE_CODE.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {t.dtype} not supported by the CUDA "
                        f"kernel (float32 or bfloat16)")
    return code


def on_card(t, what: str) -> bool:
    """True for a CUDA tensor (its wrapper launches the kernel), False for
    a CPU one (its wrapper runs the plain version); any other device
    raises ``RuntimeError``.  Reads ``is_cuda`` first: building the
    ``torch.device`` costs about a microsecond a call."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"{what}: no kernel for device {t.device}")


def stream_ptr(index: int) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on card
    ``index`` (``Tensor.get_device()``), read anew on every call, so a
    launch inside ``torch.cuda.stream(s)`` goes to ``s``.  Reads the raw
    pointer without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(index)


def check_aligned(what: str, rows: dict, tensors: dict) -> None:
    """Raise ``ValueError`` unless every row length in ``rows`` (name ->
    bytes) and every tensor's start address in ``tensors`` (name -> tensor)
    is a multiple of 16 bytes: the kernels copy with 16-byte ``cp.async``."""
    bad = [f"{n} rows of {b} bytes" for n, b in rows.items() if b % 16]
    bad += [f"{n} starting at byte {t.data_ptr() % 16} of 16"
            for n, t in tensors.items()
            if t is not None and t.data_ptr() % 16]
    if bad:
        raise ValueError(f"{what}: not 16-byte aligned ({', '.join(bad)}): "
                         f"the CUDA kernel copies 16 bytes at a time")


def check_launch(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
