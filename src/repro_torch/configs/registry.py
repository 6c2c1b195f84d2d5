"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers: every architecture of the JAX registry, in its order.
``ASSIGNED`` is JAX's ``ASSIGNED``, its first ten: what the dry run's
``--all`` covers."""
from importlib import import_module

_MODULES = {
    "yi-9b": "repro_torch.configs.yi_9b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0p5b",
    # paper §VI-D real-world models
    "bert-moe": "repro_torch.configs.bert_moe",
    "gpt2-moe": "repro_torch.configs.gpt2_moe",
}

ASSIGNED = tuple(_MODULES)[:10]


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r} for the port; known: "
                       f"{sorted(_MODULES)}")
    return import_module(_MODULES[name]).CONFIG
