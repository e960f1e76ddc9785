"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000, RG-LRU + local attention, 1 attn : 2 recurrent (Griffin).
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    d_ff=12288,
    vocab_size=256000,
    attention=AttentionConfig(n_heads=16, n_kv_heads=1, head_dim=256,
                              pattern="griffin", window=2048),
    rglru_width=4096,
    rglru_conv_size=4,
    act="gelu", glu=True,
    tie_embeddings=True,
    # recurrent state + windowed local attention: long_500k is planned
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
