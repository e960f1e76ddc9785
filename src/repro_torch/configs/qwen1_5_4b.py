"""qwen1.5-4b [dense] — 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5-0.5B family; hf]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    d_ff=6912,
    vocab_size=151936,
    attention=AttentionConfig(n_heads=20, n_kv_heads=20, head_dim=128,
                              qkv_bias=True, pattern="full",
                              rope_theta=1e6),
    act="silu", glu=True,
)
