"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000, local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    d_ff=14336,
    vocab_size=256000,
    attention=AttentionConfig(n_heads=16, n_kv_heads=8, head_dim=256,
                              pattern="alternating", window=4096,
                              logit_softcap=50.0, rope_theta=10000.0),
    final_logit_softcap=30.0,
    act="gelu", glu=True,         # GeGLU
    tie_embeddings=True,
    # local layers keep the 4096 window: long_500k is planned
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
