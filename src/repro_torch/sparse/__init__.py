"""LGRASS as a long-context attention-mask planner (beyond the paper)."""
from repro_torch.sparse.attention_graph import (BlockMaskPlan,
                                                block_sparse_attention,
                                                build_block_graph,
                                                plan_block_mask)

__all__ = ["BlockMaskPlan", "block_sparse_attention", "build_block_graph",
           "plan_block_mask"]
