"""Architecture configuration schema + shape registry.

Every assigned architecture is a frozen ``ArchConfig``; the four input-shape
cells (train_4k / prefill_32k / decode_32k / long_500k) are ``ShapeConfig``s.
``smoke()`` derives a reduced same-family config for CPU tests; the FULL
configs are only ever lowered via ShapeDtypeStructs (no allocation).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "shape_applicable"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | ssm | moe | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False           # qwen1.5
    qk_norm: bool = False            # gemma3
    mlp_kind: str = "swiglu"         # swiglu | gelu (musicgen)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- local/global attention (gemma3) ---
    sliding_window: Optional[int] = None   # window for local layers
    global_period: int = 0                 # every Nth layer is global (0 = all global)
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_period: int = 1               # MoE every Nth layer (llama4: 2)
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # --- SSM (mamba1/mamba2) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64            # mamba2 heads
    ssm_kind: str = ""                # "mamba1" | "mamba2"
    # --- hybrid (zamba2) ---
    shared_attn_period: int = 0       # every Nth block runs the shared attn block
    # --- multimodal stub frontend ---
    frontend: Optional[str] = None    # None | "audio" | "vision"
    n_patches: int = 256              # vision stub: patch positions per sample
    # --- training ---
    max_seq: int = 131_072

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, self.d_model // 16)

    def is_global_layer(self, i: int) -> bool:
        if self.global_period <= 0 or self.sliding_window is None:
            return True
        return (i + 1) % self.global_period == 0

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        return (i + 1) % self.moe_period == 0

    def is_attn_block(self, i: int) -> bool:
        """hybrid (zamba2): every shared_attn_period-th block appends the
        shared attention block after the mamba block."""
        if self.shared_attn_period <= 0:
            return False
        return (i + 1) % self.shared_attn_period == 0

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        period = max(self.global_period, self.moe_period if self.n_experts else 1,
                     self.shared_attn_period, 1)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2 * period, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 * self.n_kv_heads // max(self.n_heads, 1)),
            head_dim=16,
            d_ff=128,
            d_ff_expert=64 if self.n_experts else 0,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            vocab=256,
            sliding_window=16 if self.sliding_window else None,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_kind == "mamba2" else self.ssm_head_dim,
            n_patches=8,
            max_seq=256,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention: run for SSM/hybrid and for
    sliding-window archs (gemma3 — only every-6th layer keeps a full-length
    cache); skip for pure full-attention archs (see DESIGN.md)."""
    if shape.name == "long_500k":
        subquadratic = (arch.family in ("ssm", "hybrid")
                        or arch.sliding_window is not None)
        if not subquadratic:
            return False, "skipped: pure full-attention arch at 524k context"
    return True, ""
