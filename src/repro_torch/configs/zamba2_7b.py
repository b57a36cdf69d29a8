"""zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64 — Mamba2 blocks + shared attention block
[arXiv:2411.15242; unverified].

81 Mamba2 blocks; every 6th block is followed by the SHARED transformer
block (one set of attention+MLP weights reused at each invocation — the
Zamba trick).  d_ff applies to the shared block's MLP."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_kind="mamba2",
    ssm_head_dim=64,
    shared_attn_period=6,
    max_seq=1_048_576,
)
