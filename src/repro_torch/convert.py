"""Load the JAX package's parameters (and AdamW state) into the port.

``torch`` cannot reproduce ``jax.random``, so parity between the two
packages is checked on the same parameters: the JAX ``Model.init`` pytree,
brought to the host as numpy arrays (``jax.tree.map(np.asarray, params)``),
goes through :func:`params_from_jax`.  The port keeps the JAX layout,
including the stacked ``run{r}`` (and an audio arch's ``encoder``) layer
dimension (the JAX model stacks each run of same-kind layers with a
leading axis for ``lax.scan``; the port indexes the same axis per layer),
so conversion is a checked leaf-by-leaf copy.  With ``mesh`` and
``dims`` it is this rank's shards of that copy (``Model.param_specs``):
the one way weights reach a rank in the multi-rank parity tests.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import Model


def _leaf(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes bfloat16: no torch view
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(tree, device, lead, path):
    if isinstance(tree, dict):
        return {k: _convert(v, device, lead, f"{path}.{k}")
                for k, v in tree.items()}
    t = _leaf(tree, device)
    if lead is not None and (t.dim() == 0 or t.shape[0] != lead):
        raise ValueError(f"{path}: expected a leading layer dimension of "
                         f"{lead}, got shape {tuple(t.shape)}")
    return t


def params_from_jax(tree_of_numpy: dict, cfg, device="cuda", mesh=None,
                    dims=None) -> dict:
    """The port's parameters for ``cfg`` from the JAX ``Model.init`` pytree
    (nested dicts of numpy arrays).  Checks that the tree has exactly the
    top-level entries of ``cfg``'s model and that every ``run{r}`` leaf
    stacks that run's layer count on its leading axis (an ``encoder`` leaf
    ``encoder_layers``).  With ``mesh`` and ``dims``: this rank's shards
    only."""
    model = Model(cfg, device=device)
    if mesh is not None:
        from repro_torch.parallel.sharding import local_tree
        specs = model.param_specs(tree_of_numpy, mesh, dims)
        tree_of_numpy = local_tree(tree_of_numpy, specs, mesh)
    runs = model.runs
    lead_of = {f"run{r}": n for r, (_, n) in enumerate(runs)}
    want = {"embed", "final_norm"} | set(lead_of)
    if not cfg.tie_embeddings:
        want.add("lm_head")
    if model.has_encoder:
        want |= {"encoder", "enc_norm"}
        lead_of["encoder"] = cfg.encoder_layers
    if set(tree_of_numpy) != want:
        raise ValueError(f"parameter tree has {sorted(tree_of_numpy)}, "
                         f"{cfg.name} needs {sorted(want)}")
    return {key: _convert(sub, device, lead_of.get(key), key)
            for key, sub in tree_of_numpy.items()}


def opt_state_from_jax(state_of_numpy: dict, cfg, device="cuda") -> dict:
    """The port's AdamW state from the JAX ``adamw_init`` / ``adamw_update``
    state (``{"mu", "nu": param-shaped trees, "step": int32 scalar}``, as
    numpy): the moments convert as parameters do, the step to a 0-d int32
    tensor."""
    if set(state_of_numpy) != {"mu", "nu", "step"}:
        raise ValueError(f"optimizer state has {sorted(state_of_numpy)}, "
                         f"want ['mu', 'nu', 'step']")
    return {"mu": params_from_jax(state_of_numpy["mu"], cfg, device),
            "nu": params_from_jax(state_of_numpy["nu"], cfg, device),
            "step": torch.tensor(int(np.asarray(state_of_numpy["step"])),
                                 dtype=torch.int32, device=device)}


def to_numpy(tree):
    """A nested dict of tensors as a nested dict of numpy arrays (bf16 as
    f32), for comparison with the JAX package's trees."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
