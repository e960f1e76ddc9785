"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, RoPE SwiGLU GQA.  [arXiv:2412.08905; hf]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab_size=200064,
    attention=AttentionConfig(n_heads=24, n_kv_heads=8, head_dim=128,
                              pattern="full", rope_theta=10000.0),
    act="silu", glu=True,
    tie_embeddings=True,   # phi4-mini ties input/output embeddings
)
