"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504,
ssm_state=16 — parallel attention + mamba heads per block (arXiv:2411.13676).

Most layers use sliding-window attention (w=1024); layers {0, 15, 31} stay
global — this is what makes long_500k decode sub-quadratic. Simplification
vs the paper: no learnable meta tokens (noted in DESIGN.md).
Heterogeneous per-layer caches force the unrolled layout.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attn_type="gqa",
    sliding_window=1024,
    global_layers=(0, 15, 31),
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=50,
    ssm_chunk=128,
    layout="unroll",
)
