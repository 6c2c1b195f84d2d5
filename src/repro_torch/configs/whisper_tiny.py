"""Whisper-tiny: encoder-decoder; mel+conv frontend is a stub (precomputed
frame embeddings, 1500 frames) [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", arch_type="audio", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab_size=51865,
    use_rope=False, norm_type="layernorm", glu=False, ffn_act="gelu",
    ffn_bias=True, qkv_bias=True, encoder_layers=4, encoder_seq=1500,
    tie_embeddings=True, source="arXiv:2212.04356")
