"""Mistral-Nemo-12B: dense GQA, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", arch_type="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=131072,
    rope_theta=1e6, source="hf:mistralai/Mistral-Nemo-Base-2407")
