"""mamba2-370m [ssm]: 48L d_model=1024, attn-free, ssm_state=128.

SSD (state-space duality) per arXiv:2405.21060. d_inner = 2*d_model = 2048,
headdim 64 -> 32 SSD heads. No attention, no FFN (Mamba2 blocks only).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attn_type="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=256,
    ssm_ngroups=1,
    tie_embeddings=True,
)
