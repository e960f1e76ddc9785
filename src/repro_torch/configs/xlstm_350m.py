"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304,
sLSTM + mLSTM blocks.  [arXiv:2405.04517; unverified]

d_ff=0 per the assignment: xLSTM blocks carry their own up/down projection
inside the (m/s)LSTM cell rather than a separate MLP.  The blocks as
configured hold 177.5 M parameters, not the 350 M of the name."""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    d_ff=0,
    vocab_size=50304,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=256),
    xlstm_mlstm_every=2,        # alternate sLSTM / mLSTM 1:1
    act="gelu", glu=False,
    tie_embeddings=True,
    # O(1) decode state: long_500k is planned
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
