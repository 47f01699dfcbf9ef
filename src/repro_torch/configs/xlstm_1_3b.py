"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks, 1 sLSTM per 8 [arXiv:2405.04517]."""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                      # xLSTM blocks carry their own up/down proj
    vocab=50_304,
    head_dim=512,
    ssm=SSMConfig(kind="xlstm", expand=2, slstm_every=8, chunk=128),
    source="arXiv:2405.04517",
)
