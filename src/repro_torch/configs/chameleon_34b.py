"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.

Early-fusion VLM (arXiv:2405.09818): image VQ tokens share the text vocab,
so the backbone is a plain decoder LM; the VQ tokenizer frontend is a stub
(`input_specs` feeds token ids that already include image tokens).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    attn_type="gqa",
    frontend="vlm",
)
