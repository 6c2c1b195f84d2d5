"""Command-R-35B: dense GQA, parallel attn||FFN blocks, no-bias LayerNorm,
tied embeddings [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", arch_type="dense", n_layers=40, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22528, vocab_size=256000,
    rope_theta=8e6, norm_type="layernorm", parallel_block=True,
    tie_embeddings=True, logit_scale=0.0625,
    source="hf:CohereForAI/c4ai-command-r-v01")
