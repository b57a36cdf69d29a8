"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409; unverified].

Backbone only: the ViT frontend is a stub — input_specs() provides
precomputed patch embeddings that are prepended to the token embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1_000_000.0,
    frontend="vision",
    n_patches=256,
    max_seq=131_072,
)
