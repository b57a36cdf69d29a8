"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=163840, MoE 64e top-6 — kimi/moonlight
[hf:moonshotai/Moonlight-16B-A3B; hf].

Every layer is MoE (64 experts, top-6) with a shared expert sized 2x1408
(Moonlight uses 2 shared experts of 1408).  The assignment's 48L at these
dims totals ~27B params (the hf checkpoint has 27 layers); we implement the
assigned 48L (DESIGN.md §6)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=2816,                  # shared-expert width (2 x 1408)
    d_ff_expert=1408,
    n_experts=64,
    top_k=6,
    moe_period=1,
    shared_expert=True,
    vocab=163840,
    rope_theta=50_000.0,
    max_seq=8_192,
)
