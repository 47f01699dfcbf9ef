"""whisper-tiny [audio] — enc-dec; conv/mel frontend is a STUB
(input_specs provides precomputed frame embeddings) [arXiv:2212.04356]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                  # decoder depth
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51_865,
    head_dim=64,
    gated_act="gelu",
    encoder_layers=4,
    encoder_seq=1500,            # 30 s of audio after the (stubbed) conv stack
    max_decode_len=448,          # architectural decode cap
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
