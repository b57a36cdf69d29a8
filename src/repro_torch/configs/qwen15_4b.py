"""qwen1.5-4b [dense]: 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936 — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

Note: the assignment's hf tag names the 0.5B checkpoint but the listed dims
are Qwen1.5-4B; we implement the listed dims (see DESIGN.md §6)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    max_seq=32_768,
)
