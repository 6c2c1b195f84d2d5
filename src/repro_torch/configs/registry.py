"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers, in the JAX registry's order.  Only the architectures whose
block kinds the port runs are listed; the JAX package's others
(llama-3.2-vision, whisper) come with the slice that runs them.
``ASSIGNED`` is JAX's ``ASSIGNED`` (its first ten) in its order, cut to
the archs listed here: what the dry run's ``--all`` covers."""
from importlib import import_module

_MODULES = {
    "yi-9b": "repro_torch.configs.yi_9b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0p5b",
    # paper §VI-D real-world models
    "bert-moe": "repro_torch.configs.bert_moe",
    "gpt2-moe": "repro_torch.configs.gpt2_moe",
}

#: JAX's ``ASSIGNED`` order, cut to the archs above
_JAX_ASSIGNED = ("yi-9b", "mistral-nemo-12b", "llama4-scout-17b-a16e",
                 "hymba-1.5b", "llama-3.2-vision-11b", "whisper-tiny",
                 "xlstm-350m", "command-r-35b", "qwen3-moe-30b-a3b",
                 "qwen1.5-0.5b")
ASSIGNED = tuple(a for a in _JAX_ASSIGNED if a in _MODULES)


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r} for the port; known: "
                       f"{sorted(_MODULES)}")
    return import_module(_MODULES[name]).CONFIG
