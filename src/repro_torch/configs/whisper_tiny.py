"""whisper-tiny [audio] — 4L d_model=384 6H d_ff=1536 vocab=51865,
encoder-decoder; the conv/mel frontend is a stub (the caller passes
precomputed 1500-frame embeddings).  [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                  # decoder layers
    enc_layers=4,                # encoder layers
    enc_seq=1500,                # precomputed frame embeddings (stub)
    d_model=384,
    d_ff=1536,
    vocab_size=51865,
    attention=AttentionConfig(n_heads=6, n_kv_heads=6, head_dim=64,
                              pattern="full"),
    act="gelu", glu=False,       # classic GELU MLP, no gating
    tie_embeddings=True,
)
