"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers.  Only the architectures the port runs are listed; the JAX
package's other configs come with the slices that run them."""
from importlib import import_module

_MODULES = {
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "gpt2-moe": "repro_torch.configs.gpt2_moe",
    "bert-moe": "repro_torch.configs.bert_moe",
}


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r} for the port; known: "
                       f"{sorted(_MODULES)}")
    return import_module(_MODULES[name]).CONFIG
