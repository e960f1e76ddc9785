"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, M-RoPE; the vision frontend is a stub (the caller passes
precomputed patch embeddings).  [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    d_ff=8960,
    vocab_size=151936,
    attention=AttentionConfig(n_heads=12, n_kv_heads=2, head_dim=128,
                              qkv_bias=True, pattern="full",
                              rope_theta=1e6,
                              mrope_sections=(16, 24, 24)),   # t/h/w splits
    vision_tokens=256,           # stub patch embeddings prepended
    act="silu", glu=True,
    tie_embeddings=True,
)
