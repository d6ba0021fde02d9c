"""The LM architecture configs of the port: a copy of `repro.configs.base`.

`ArchConfig` (its `reduced()` variant for CPU tests included),
`ShapeConfig`, `SHAPES` and `cell_skip_reason` are the JAX package's,
field for field, so a config means the same model in both packages. The
port keeps its own copy because it never imports `repro`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    attn_type: str = "gqa"           # gqa | mla | none
    is_encoder: bool = False
    act: str = "swiglu"              # swiglu | gelu
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    global_layers: Tuple[int, ...] = ()
    # MLA (multi-head latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    ssm_ngroups: int = 1
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # modality frontend stub
    frontend: Optional[str] = None   # audio | vlm | None
    feat_dim: int = 0
    # numerics / misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    layout: str = "scan"             # scan | unroll (hybrid uses unroll)
    # book-keeping for padding (0 = not padded)
    real_n_heads: int = 0
    real_n_kv_heads: int = 0
    real_vocab_size: int = 0
    real_n_experts: int = 0

    # ---------------- derived ----------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def has_attention(self) -> bool:
        return self.attn_type != "none"

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic path: pure SSM, or hybrid with sliding windows."""
        if not self.has_attention:
            return True
        return self.sliding_window is not None

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder

    def n_params(self) -> int:
        """True parameter count (unpadded dims)."""
        d, v, f = self.d_model, self.vocab_size, self.d_ff
        hd = self.resolved_head_dim
        per_layer = 0
        if self.has_attention:
            if self.attn_type == "mla":
                per_layer += d * self.q_lora_rank
                per_layer += self.q_lora_rank * self.n_heads * (
                    self.qk_nope_head_dim + self.qk_rope_head_dim
                )
                per_layer += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                per_layer += self.kv_lora_rank * self.n_heads * (
                    self.qk_nope_head_dim + self.v_head_dim
                )
                per_layer += self.n_heads * self.v_head_dim * d
                per_layer += self.q_lora_rank + self.kv_lora_rank
            else:
                per_layer += d * self.n_heads * hd
                per_layer += 2 * d * self.n_kv_heads * hd
                per_layer += self.n_heads * hd * d
        if self.has_ssm:
            di = self.d_inner
            conv_dim = di + 2 * self.ssm_ngroups * self.ssm_state
            per_layer += d * (2 * di + 2 * self.ssm_ngroups * self.ssm_state
                              + self.ssm_nheads)
            per_layer += self.ssm_conv * conv_dim
            per_layer += 3 * self.ssm_nheads + di  # A_log, D, dt_bias, norm
            per_layer += di * d
        if self.is_moe:
            per_layer += d * self.n_experts
            nmat = 3 if self.act == "swiglu" else 2
            per_layer += self.n_experts * nmat * d * f
        elif f > 0:
            nmat = 3 if self.act == "swiglu" else 2
            per_layer += nmat * d * f
        per_layer += 2 * d  # norms
        total = self.n_layers * per_layer + v * d + 2 * d
        if not self.tie_embeddings:
            total += v * d
        if self.frontend == "audio":
            total += self.feat_dim * d
        return total

    # ---------------- variants ----------------
    def padded_for_mesh(self, tp: int) -> "ArchConfig":
        """Pad heads / kv heads / vocab / experts for a `tp`-way model axis."""
        ch: Dict = {}
        nh = self.n_heads
        nkv = self.n_kv_heads
        if self.has_attention and nh % tp != 0:
            new_h = _round_up(nh, tp)
            ch["n_heads"] = new_h
            ch["real_n_heads"] = nh
            if self.attn_type == "gqa" and nkv > 0:
                # smallest kv' >= kv that divides the padded head count,
                # so GQA grouping stays integral after padding
                new_kv = next(k for k in range(nkv, new_h + 1)
                              if new_h % k == 0)
                if new_kv != nkv:
                    ch["n_kv_heads"] = new_kv
                    ch["real_n_kv_heads"] = nkv
        if self.vocab_size % tp != 0:
            ch["vocab_size"] = _round_up(self.vocab_size, tp)
            ch["real_vocab_size"] = self.vocab_size
        if self.is_moe and self.n_experts % tp != 0:
            ch["n_experts"] = _round_up(self.n_experts, tp)
            ch["real_n_experts"] = self.n_experts
        if not ch:
            return self
        return dataclasses.replace(self, **ch)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (exact code paths)."""
        ch: Dict = dict(
            n_layers=2,
            d_model=64,
            d_ff=128 if self.d_ff else 0,
            vocab_size=97,
            dtype="float32",
            remat=False,
        )
        if self.has_attention:
            if self.attn_type == "mla":
                ch.update(n_heads=4, q_lora_rank=24, kv_lora_rank=16,
                          qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8)
            else:
                group = max(1, self.n_heads // max(self.n_kv_heads, 1))
                ch.update(n_heads=4, n_kv_heads=max(1, 4 // group),
                          head_dim=16)
        if self.has_ssm:
            ch.update(ssm_state=8, ssm_headdim=16, ssm_chunk=16, ssm_conv=4)
        if self.is_moe:
            # cf=8: no capacity drops, so prefill+decode == full forward
            # exactly (drop policies are exercised in test_moe.py)
            ch.update(n_experts=4, moe_top_k=min(2, self.moe_top_k),
                      capacity_factor=8.0)
        if self.sliding_window:
            ch.update(sliding_window=16, global_layers=(0,))
        if self.frontend:
            ch.update(feat_dim=32)
        ch.update(real_n_heads=0, real_n_kv_heads=0, real_vocab_size=0,
                  real_n_experts=0)
        return dataclasses.replace(self, **ch)


# ---------------- input shapes (assignment) ----------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_skip_reason(cfg: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    """Assignment rules: which (arch × shape) cells are skipped and why."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("pure full-attention arch: 500k decode needs sub-quadratic "
                "attention (see DESIGN.md)")
    return None
