"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA + RoPE, gelu MLP (arXiv:2402.19173)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    attn_type="gqa",
    act="gelu",
)
