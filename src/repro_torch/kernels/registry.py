"""Kernel seam of the port (counterpart of ``repro/kernels/registry.py``).

``get_op(name, cfg=, **static)`` returns the op ``name`` with its static
parameters bound.  The backend follows the tensor: a CUDA tensor launches
the hand-written CUDA kernel (or the wrapper raises), a CPU tensor runs the
plain PyTorch version.  There is no backend override, so a CUDA tensor can
never fall back to the plain version.

Ops of this slice: ``rmsnorm`` (static ``eps``) and ``expert_ffn_grouped``
(static ``cap``, ``act``, ``wire``).  The other five TPU kernels of the JAX
package come with later slices.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.kernels.expert_ffn_grouped import expert_ffn_grouped
from repro_torch.kernels.rmsnorm import rmsnorm


@dataclass(frozen=True)
class KernelConfig:
    """The JAX package's kernel config, field for field, so that model
    configs carry over unchanged.  In the port ``backend`` must stay
    ``"auto"`` (the device decides) and ``interpret`` unset; the tile sizes
    are accepted for parity, while the CUDA kernels' tiles are compile-time
    constants in ``csrc/``."""

    backend: str = "auto"
    interpret: Optional[bool] = None
    block_t: int = 128
    block_f: int = 256
    block_s: int = 256
    block_r: int = 256
    block_q: int = 128
    block_k: int = 128


DEFAULT = KernelConfig()

_OPS = {"rmsnorm": rmsnorm, "expert_ffn_grouped": expert_ffn_grouped}


def list_ops() -> tuple:
    return tuple(sorted(_OPS))


def get_op(name: str, *, cfg: Optional[KernelConfig] = None,
           **static) -> Callable:
    """The op ``name`` with ``static`` keyword parameters bound."""
    cfg = cfg or DEFAULT
    if cfg.backend != "auto" or cfg.interpret is not None:
        raise ValueError(
            f"KernelConfig(backend={cfg.backend!r}, interpret="
            f"{cfg.interpret!r}): the port picks the backend from the "
            "tensor's device; leave both at their defaults")
    if name not in _OPS:
        raise KeyError(f"no kernel op {name!r} in this slice of the port "
                       f"(have {list_ops()})")
    return functools.partial(_OPS[name], **static)
