"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512,
vocab=49155, MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    d_ff=512,                    # per-expert hidden size
    vocab_size=49155,
    attention=AttentionConfig(n_heads=16, n_kv_heads=8, head_dim=64,
                              pattern="full"),
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
    act="silu", glu=True,
    tie_embeddings=True,
)
