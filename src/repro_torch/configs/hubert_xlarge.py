"""hubert-xlarge [audio]: 48L d_model=1280 16H (MHA) d_ff=5120 vocab=504 —
encoder-only masked prediction over 504 cluster classes (arXiv:2106.07447).

The conv waveform frontend is a STUB: input_specs() provides precomputed
frame features (B, T, 512) which a linear projection lifts to d_model.
Positional information uses RoPE (adaptation: the original conv-positional
encoder is frontend-side; noted in DESIGN.md). No decode shapes (encoder).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    attn_type="gqa",
    is_encoder=True,
    act="gelu",
    frontend="audio",
    feat_dim=512,
)
