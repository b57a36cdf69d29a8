"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144 — 5:1 local:global sliding window, 128k context
[hf:google/gemma-3-1b-pt; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    qk_norm=True,
    sliding_window=512,
    global_period=6,           # every 6th layer global => 5:1 local:global
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    max_seq=131_072,
)
