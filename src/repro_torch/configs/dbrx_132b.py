"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, 16 experts top-4 fine-grained (hf:databricks/dbrx-base)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    attn_type="gqa",
    n_experts=16,
    moe_top_k=4,
)
