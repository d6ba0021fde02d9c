"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8 (fine-grained, per-expert d_ff=512).

NOTE: the assignment's shape line says "MoE 40e top-8" while its prose
says "32 experts top-8"; we follow the structured shape line (40e).
[hf:ibm-granite/granite-3.0-1b-a400m-base family]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    attn_type="gqa",
    n_experts=40,
    moe_top_k=8,
)
