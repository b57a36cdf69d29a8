"""Model assembly for the dense family: the JAX package's generic decoder
stack (``models/model.py``) for configs with ``family == "dense"`` and no
frontend (gemma3-1b, gemma3-27b, granite-8b, qwen1.5-4b).

Layer weights are stacked on a leading block axis, as in the JAX package:
``params["blocks"]["pos{j}"]`` holds the j-th layer of every repetition of
the layer pattern (gemma3: 5 local + 1 global), and ``params["rem"]
["rem{j}"]`` the ``n_layers % period`` remainder layers, which take the
kinds of pattern positions 0, 1, ...  The JAX ``lax.scan`` over blocks is a
Python loop over the block axis here; ``shard(...)`` is a no-op without a
mesh and is dropped.  Local layers get window-sized rolling KV caches,
global ones full-length caches.

Modes:
  * train:   full-sequence causal; returns (logits, aux)
  * prefill: full-sequence causal + fills the KV caches; returns
             (last-position logits, caches, aux)
  * decode:  one token against the caches; returns (logits, caches)

Unlike the JAX package, prefill and decode write the caches IN PLACE (the
returned caches are the tensors passed in): one full-width cache is then
never copied per step.  ``impl`` "flash" runs the kernels (K3 RMSNorm, K4
prefill attention) on CUDA; "ref" the plain versions throughout.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from .layers import (IMPLS, attention_apply, dense_init, init_attention,
                     init_mlp, mlp_apply, rms_norm, rope, zeros)

__all__ = ["pattern_period", "layer_kind", "init_params", "param_count",
           "init_caches", "forward", "check_supported"]

Tree = Dict[str, Any]


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is not ported yet "
            f"(ROADMAP Queue A item 13d)")
    if cfg.family != "dense":
        item = {"moe": "13b", "ssm": "13c", "hybrid": "13c"}.get(cfg.family,
                                                                 "13d")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"Queue A item {item}); the port runs the dense family")


# ---------------------------------------------------------------------------
# pattern machinery
# ---------------------------------------------------------------------------

def pattern_period(cfg: ArchConfig) -> int:
    """Layers per repetition of the dense layer pattern (gemma3: 6)."""
    if cfg.sliding_window is not None and cfg.global_period > 0:
        return cfg.global_period
    return 1


def layer_kind(cfg: ArchConfig, j: int) -> Dict[str, Any]:
    """Kind of the dense layer at pattern position j (absolute index
    i = j mod P): its attention window, None for a global layer."""
    window = None
    if cfg.sliding_window is not None and not cfg.is_global_layer(j):
        window = cfg.sliding_window
    return {"window": window}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(cfg: ArchConfig, generator, dtype, device, lead=()) -> Tree:
    return {"ln1": zeros(lead + (cfg.d_model,), dtype, device),
            "attn": init_attention(generator, cfg, dtype, device, lead),
            "ln2": zeros(lead + (cfg.d_model,), dtype, device),
            "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                            dtype, device, lead)}


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                *, device=None, dtype=torch.float32) -> Tree:
    """Random parameters in the JAX package's layout.  ``device`` None =
    CUDA (raises without a card); "cpu"; or "meta" for shapes alone.
    ``generator`` (on ``device``; None = a fresh one seeded 0) draws every
    weight; norms and biases start at zero.  torch's normals are not
    ``jax.random``'s: parity tests carry the JAX parameters across with
    ``convert.params_from_jax``."""
    check_supported(cfg)
    dev = torch.device("meta") if device == "meta" else resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    per = pattern_period(cfg)
    n_blocks, n_rem = divmod(cfg.n_layers, per)
    params: Tree = {
        "embed": dense_init(generator, cfg.vocab, cfg.d_model, dtype, dev),
        "final_norm": zeros((cfg.d_model,), dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab,
                                       dtype, dev)
    params["blocks"] = {
        f"pos{j}": _init_layer(cfg, generator, dtype, dev, (n_blocks,))
        for j in range(per)} if n_blocks > 0 else {}
    params["rem"] = {f"rem{j}": _init_layer(cfg, generator, dtype, dev)
                     for j in range(n_rem)}
    return params


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def param_count(params: Tree) -> int:
    return sum(x.numel() for x in _leaves(params))


def _index(tree: Tree, i: int) -> Tree:
    """Entry i of every tensor of a block-stacked tree (views)."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.float32, device=None) -> Tree:
    """Zeroed KV caches: (n_blocks, B, Hkv, S, hd) per pattern position and
    (B, Hkv, S, hd) per remainder layer, S = min(window, max_len) for a
    local layer and max_len for a global one."""
    check_supported(cfg)
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"KV cache dtype {dtype}: only fp32 / bf16 are ported (the fp8 "
            f"cache is ROADMAP Queue A item 13e)")
    dev = resolve_device(device)
    per = pattern_period(cfg)
    n_blocks, n_rem = divmod(cfg.n_layers, per)

    def one(kind, lead):
        w = kind["window"]
        s = max_len if w is None else min(w, max_len)
        shape = lead + (batch, cfg.n_kv_heads, s, cfg.hd)
        return {"k": zeros(shape, dtype, dev), "v": zeros(shape, dtype, dev)}

    return {"blocks": {f"pos{j}": one(layer_kind(cfg, j), (n_blocks,))
                       for j in range(per)} if n_blocks > 0 else {},
            "rem": {f"rem{j}": one(layer_kind(cfg, j), ())
                    for j in range(n_rem)}}


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _write_prefill_cache(cache_kv: Tree, k_new: torch.Tensor,
                         v_new: torch.Tensor) -> None:
    """Fill a KV cache in place from prefill K/V (B, Hkv, S, hd); for a
    window-sized cache the last S_c positions land at their rolling slots
    ``pos % S_c``."""
    s_c = cache_kv["k"].shape[2]
    s = k_new.shape[2]
    if s >= s_c:
        slots = torch.arange(s - s_c, s, device=k_new.device) % s_c
        cache_kv["k"][:, :, slots] = k_new[:, :, s - s_c:].to(
            cache_kv["k"].dtype)
        cache_kv["v"][:, :, slots] = v_new[:, :, s - s_c:].to(
            cache_kv["v"].dtype)
    else:
        cache_kv["k"][:, :, :s] = k_new.to(cache_kv["k"].dtype)
        cache_kv["v"][:, :, :s] = v_new.to(cache_kv["v"].dtype)


def _prefill_kv(cfg: ArchConfig, ap: Tree, h: torch.Tensor,
                positions: torch.Tensor, cache: Tree, plain: bool) -> None:
    """Write K/V into the prefill cache (rope'd, in decode's layout),
    recomputed from h as the JAX package does."""
    b, s, _ = h.shape
    k = h @ ap["wk"]
    v = h @ ap["wv"]
    if cfg.qkv_bias:
        k, v = k + ap["bk"], v + ap["bv"]
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        k = rms_norm(k, ap["k_norm"], cfg.norm_eps, plain)
    k = rope(k, positions, cfg.rope_theta)
    _write_prefill_cache(cache, k.transpose(1, 2), v.transpose(1, 2))


def _attn_mlp_layer(cfg: ArchConfig, kind, lp: Tree, x: torch.Tensor, *,
                    positions, cache, cache_pos, mode, impl) -> torch.Tensor:
    window = kind["window"]
    plain = impl == "ref"
    h = rms_norm(x, lp["ln1"], cfg.norm_eps, plain)
    if mode == "decode":
        attn_out, _ = attention_apply(
            lp["attn"], h, cfg, positions=positions, window=window,
            cache=(cache["k"], cache["v"]), cache_pos=cache_pos, impl=impl)
    else:
        attn_out, _ = attention_apply(lp["attn"], h, cfg, positions=positions,
                                      window=window, impl=impl)
        if mode == "prefill":
            _prefill_kv(cfg, lp["attn"], h, positions, cache, plain)
    x = x + attn_out
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps, plain)
    return x + mlp_apply(lp["mlp"], h2, cfg.mlp_kind)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(cfg: ArchConfig, params: Tree, tokens: torch.Tensor, *,
            mode: str = "train", caches: Optional[Tree] = None,
            pos: Optional[int] = None, impl: str = "flash"):
    """tokens (B, S) integer (S = 1 for decode, at absolute position
    ``pos``).  See the module docstring for what each mode returns."""
    check_supported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if mode != "train" and caches is None:
        raise ValueError(f"mode {mode!r} needs caches (init_caches)")
    per = pattern_period(cfg)
    kinds = [layer_kind(cfg, j) for j in range(per)]
    n_blocks, n_rem = divmod(cfg.n_layers, per)

    x = params["embed"][tokens]
    if cfg.qk_norm:                          # gemma3 scales embeddings
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    s = x.shape[1]
    if mode == "decode":
        if pos is None:
            raise ValueError("decode needs pos")
        cache_pos = int(pos)
        positions = torch.tensor([cache_pos], dtype=torch.int32,
                                 device=x.device)
    else:
        cache_pos = None
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    kw = dict(positions=positions, cache_pos=cache_pos, mode=mode, impl=impl)

    for i in range(n_blocks):
        for j in range(per):
            lp = _index(params["blocks"][f"pos{j}"], i)
            cache = None if mode == "train" else \
                _index(caches["blocks"][f"pos{j}"], i)
            x = _attn_mlp_layer(cfg, kinds[j], lp, x, cache=cache, **kw)
    for j in range(n_rem):
        cache = None if mode == "train" else caches["rem"][f"rem{j}"]
        x = _attn_mlp_layer(cfg, kinds[j], params["rem"][f"rem{j}"], x,
                            cache=cache, **kw)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps, impl == "ref")
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "train":
        return x @ head, aux
    # prefill / decode: only the last position's logits are needed
    logits = x[:, -1, :] @ head
    if mode == "prefill":
        return logits, caches, aux
    return logits, caches
