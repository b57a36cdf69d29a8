"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
expert d_ff=8192 vocab=202048, MoE 128e top-1 — early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

MoE every OTHER layer (moe_period=2, 24 MoE layers): all-layer MoE at these
dims would be ~775B params, contradicting the 400B name; interleaved MoE +
dense d_ff 16384 + shared expert reproduces ~400B total / ~17B active
(DESIGN.md §6).  Early fusion: optional vision embeddings are fused into the
token stream by the stub frontend."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,                 # dense-layer / shared-expert width
    d_ff_expert=8192,
    n_experts=128,
    top_k=1,
    moe_period=2,
    shared_expert=True,
    vocab=202048,
    rope_theta=500_000.0,
    frontend="vision",          # early fusion (stub patch embeddings)
    n_patches=256,
    max_seq=131_072,
)
