"""Llama-3.2-11B-Vision: language tower with gated cross-attention layers
every 5th layer; ViT frontend is a stub (precomputed patch embeddings)
[hf:meta-llama/Llama-3.2-11B-Vision]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", arch_type="vlm", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=128256,
    rope_theta=5e5, cross_every=5, n_ctx_tokens=1601,
    source="hf:meta-llama/Llama-3.2-11B-Vision")
