"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only: the EnCodec frontend is a stub — input_specs() provides the
token stream directly (one codebook stream; the 4-codebook delay pattern is
a data-layout concern, not a backbone concern).  MLP is plain GELU (the
original is a standard transformer, not SwiGLU)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=2048,
    mlp_kind="gelu",
    frontend="audio",
    max_seq=32_768,
)
