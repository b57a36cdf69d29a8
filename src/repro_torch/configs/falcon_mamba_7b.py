"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attn-free) vocab=65024,
ssm_state=16 — mamba1 arch [arXiv:2410.05355; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_kind="mamba1",
    max_seq=1_048_576,
)
