"""Model assembly: the JAX package's generic decoder stack
(``models/model.py``) for every config of the repo: ``family`` "dense"
(gemma3-1b, gemma3-27b, granite-8b, qwen1.5-4b), "moe"
(moonshot-v1-16b-a3b, llama4-maverick), "ssm" (falcon-mamba-7b), "hybrid"
(zamba2-7b), "vlm" (pixtral-12b) and "audio" (musicgen-large), the last two
dense stacks.  The frontends are the reference's stubs: a "vision" config
(pixtral, llama4) takes precomputed patch embeddings ``vision_embeds`` (B,
Np, d), projects them by ``params["vision_proj"]`` (d, d) and prepends
them to the token embeddings (early fusion), so prefill and train run over
Np + S positions; without them it runs text-only.  An "audio" config
(musicgen) takes its EnCodec token stream as tokens.

Layer weights are stacked on a leading block axis, as in the JAX package:
``params["blocks"]["pos{j}"]`` holds the j-th layer of every repetition of
the layer pattern (gemma3: 5 local + 1 global; llama4: a dense layer, then
an MoE one; zamba2: 6 Mamba2 layers, the last followed by the shared
attention block), and ``params["rem"]["rem{j}"]`` the ``n_layers % period``
remainder layers, which take the kinds of pattern positions 0, 1, ...  The
JAX ``lax.scan`` over blocks is a Python loop over the block axis here.
Local layers get window-sized rolling KV caches, global ones full-length
caches.  An MoE layer (``models.moe``) replaces the MLP with routed
experts, plus a shared expert where the config has one; its router's load-balancing loss is the
layer's aux, summed over the layers in order.  An SSM layer
(``models.mamba``) is a norm and a Mamba1 or Mamba2 block; its cache is
the conv state (in the cache dtype) and the SSM state (always fp32).  In
the hybrid family one set of attention + MLP weights,
``params["shared_attn"]``, runs after every ``shared_attn_period``-th SSM
layer, each call with its own full-length K/V cache in that layer's cache.

Modes:
  * train:   full-sequence causal; returns (logits, aux)
  * train_hidden: as train, but returns (x, head, aux), the final hidden
             states and the head, for a chunked cross-entropy that never
             holds the (B, S, V) logits
  * prefill: full-sequence causal + fills the caches; returns
             (last-position logits, caches, aux)
  * decode:  one token against the caches; returns (logits, caches)

Unlike the JAX package, prefill and decode write the caches IN PLACE (the
returned caches are the tensors passed in): one full-width cache is then
never copied per step.  KV caches are fp32, bf16 or float8_e4m3fn, every
write cast by ``layers.to_cache_dtype`` (the reference's ``astype``
bytes); with an fp8 cache an SSM layer's conv state is bf16 and its SSM
state fp32, as in the reference.  The reference's decode step returns the
conv state in its arithmetic's dtype (fp32 with fp32 weights), so the
first decode step widens a narrower conv state in the tree to that dtype,
as the reference's returned caches carry it.  ``impl`` "flash" runs the
kernels (K3 RMSNorm, K4 prefill attention, K5 Mamba1's scan, K6 decode
attention) on CUDA; "ref" the plain versions throughout.  In the train
modes K3, K4 and K5 are autograd Functions (K3b, K4b and K5b backward).
``remat`` recomputes each repetition of the layer pattern in the backward
(``torch.utils.checkpoint``, non-reentrant), saving only its input, as
the JAX package's
``jax.checkpoint(..., nothing_saveable)`` over its scan body; the
remainder layers and the final norm are not recomputed, as there.

**Over a mesh** (``mesh``, a ``launch.mesh.Mesh`` with a ``model`` axis
and ``data_axes``; every mode and family): ``params`` are this rank's
blocks by ``launch.shardings.param_specs``, ``tokens`` its data shard by
``batch_specs`` and ``caches`` its blocks by ``cache_specs``
(``init_caches(..., mesh=, rank=)``, with ``max_len`` the caches' whole
length passed to every prefill and decode).  Attention and MLPs are
Megatron tensor-parallel over ``model`` (``layers``; decode reads a
cache split over KV heads or over slots), MoE layers expert-parallel
(``moe``), Mamba1 / Mamba2 blocks tensor-parallel over d_inner / their
heads (``mamba``); the embedding is vocab-parallel (a rank looks up the
ids of its vocabulary range, zero rows elsewhere, summed over the model
group), ``vision_proj`` column-parallel and gathered, and the head
(``lm_head``, or ``embed.T`` when tied) gives this rank's vocabulary
columns of the logits in every mode (``train_step``'s vocab-parallel
cross-entropy; ``launch.serve.generate``'s greedy pick over the ranks).
The residual stream is replicated over ``model``, where the reference's
``shard(x, "batch", "seq", "embed")`` lets its partitioner split it
(Megatron-SP); the port's ``models.sharding.shard`` moves nothing.  A mesh
of one rank on every axis is the one-device path, bitwise.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import distributed as D
from ..configs.base import ArchConfig
from ..device import resolve_device
from .layers import (CACHE_DTYPES, IMPLS, attention_apply,
                     dense_init, gather_columns, init_attention, init_mlp,
                     kv_block, mlp_apply, rms_norm, rope, write_cache,
                     zeros)
from . import mamba as M
from . import moe

__all__ = ["pattern_period", "layer_kind", "init_params", "param_count",
           "init_caches", "cache_layout", "forward", "check_supported",
           "MODES", "mesh_groups"]

Tree = Dict[str, Any]
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
FRONTENDS = (None, "vision", "audio")
SSM_TYPES = ("mamba1", "mamba2")


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for a family or frontend the port does not
    know."""
    if cfg.frontend not in FRONTENDS:
        raise NotImplementedError(
            f"{cfg.name}: frontend {cfg.frontend!r} is not one of "
            f"{FRONTENDS}")
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not one of {FAMILIES}")


# ---------------------------------------------------------------------------
# pattern machinery
# ---------------------------------------------------------------------------

def pattern_period(cfg: ArchConfig) -> int:
    """Layers per repetition of the layer pattern (gemma3: 6; llama4: 2;
    zamba2: 6)."""
    if cfg.family == "hybrid":
        return max(cfg.shared_attn_period, 1)
    if cfg.family == "moe":
        return max(cfg.moe_period, 1)
    if cfg.sliding_window is not None and cfg.global_period > 0:
        return cfg.global_period
    return 1


def layer_kind(cfg: ArchConfig, j: int) -> Dict[str, Any]:
    """Kind of the layer at pattern position j (absolute index i = j mod
    P): its type, "moe" or "dense" and its attention window (None for a
    global layer); or, in the SSM families, its type, "mamba1" or
    "mamba2", and whether the shared attention block follows it."""
    if cfg.family in ("ssm", "hybrid"):
        return {"type": cfg.ssm_kind,
                "shared_attn": cfg.family == "hybrid"
                and cfg.is_attn_block(j)}
    window = None
    if cfg.sliding_window is not None and not cfg.is_global_layer(j):
        window = cfg.sliding_window
    return {"type": "moe" if cfg.is_moe_layer(j) else "dense",
            "window": window}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(cfg: ArchConfig, kind, generator, dtype, device,
                lead=()) -> Tree:
    if kind["type"] in SSM_TYPES:
        init = M.init_mamba1 if kind["type"] == "mamba1" else M.init_mamba2
        return {"ln": zeros(lead + (cfg.d_model,), dtype, device),
                "mamba": init(generator, cfg, dtype, device, lead)}
    p = {"ln1": zeros(lead + (cfg.d_model,), dtype, device),
         "attn": init_attention(generator, cfg, dtype, device, lead),
         "ln2": zeros(lead + (cfg.d_model,), dtype, device)}
    if kind["type"] == "moe":
        p["moe"] = moe.init_moe(generator, cfg, dtype, device, lead)
        if cfg.shared_expert:
            p["shared_mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff,
                                       cfg.mlp_kind, dtype, device, lead)
    else:
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                            dtype, device, lead)
    return p


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                *, device=None, dtype=torch.float32) -> Tree:
    """Random parameters in the JAX package's layout.  ``device`` None =
    CUDA (raises without a card); "cpu"; or "meta" for shapes alone.
    ``generator`` (on ``device``; None = a fresh one seeded 0) draws every
    weight; norms and biases start at zero.  torch's normals are not
    ``jax.random``'s: parity tests carry the JAX parameters across with
    ``convert.params_from_jax``."""
    check_supported(cfg)
    dev = _device(device)
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
    if cfg.frontend == "vision":
        params["vision_proj"] = dense_init(generator, cfg.d_model,
                                           cfg.d_model, dtype, dev)
    params["blocks"] = {
        f"pos{j}": _init_layer(cfg, layer_kind(cfg, j), generator, dtype,
                               dev, (n_blocks,))
        for j in range(per)} if n_blocks > 0 else {}
    params["rem"] = {f"rem{j}": _init_layer(cfg, layer_kind(cfg, j),
                                            generator, dtype, dev)
                     for j in range(n_rem)}
    if cfg.family == "hybrid":
        params["shared_attn"] = {
            "ln1": zeros((cfg.d_model,), dtype, dev),
            "attn": init_attention(generator, cfg, dtype, dev),
            "ln2": zeros((cfg.d_model,), dtype, dev),
            "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                            dtype, dev)}
    return params


def _device(device) -> torch.device:
    """``device`` resolved by the device rule, or the ``meta`` device (a
    plan's shapes) where it names it."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


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
                dtype=torch.float32, device=None, *, mesh=None,
                rank: Optional[int] = None, data_axes=("data",)) -> Tree:
    """Zeroed caches: KV (n_blocks, B, Hkv, S, hd) per pattern position
    and (B, Hkv, S, hd) per remainder layer in ``dtype`` (fp32, bf16 or
    float8_e4m3fn), S = min(window, max_len) for a local layer and max_len
    for a global one; for an SSM layer its conv state in ``dtype`` (bf16
    for an fp8 cache: the reference keeps fp8 to the K/V buffers) and its
    SSM state in fp32 (``mamba*_state_shape``), plus a full-length K/V
    where the shared attention block follows it.  ``device`` "meta" gives
    the shapes alone.  With ``mesh`` and ``rank``: only global rank
    ``rank``'s block of each leaf by :func:`cache_layout`, allocated at
    its block's shape."""
    check_supported(cfg)
    if dtype not in CACHE_DTYPES:
        raise ValueError(f"KV cache dtype {dtype}: one of {CACHE_DTYPES}")
    state_dtype = torch.bfloat16 if dtype == torch.float8_e4m3fn else dtype
    dev = _device(device)
    per = pattern_period(cfg)
    n_blocks, n_rem = divmod(cfg.n_layers, per)
    if mesh is not None:
        from ..launch.shardings import local_shape, tree_map_with_path

        if rank is None:
            raise ValueError("caches over a mesh need the rank")
        meta = init_caches(cfg, batch, max_len, dtype, "meta")
        return tree_map_with_path(
            lambda path, m, sp: zeros(local_shape(tuple(m.shape), sp, mesh),
                                      m.dtype, dev),
            meta, cache_layout(cfg, batch, max_len, mesh, data_axes, dtype))

    def one(kind, lead):
        cache = {}
        if kind["type"] in SSM_TYPES:
            shp = (M.mamba1_state_shape if kind["type"] == "mamba1"
                   else M.mamba2_state_shape)(cfg, batch)
            cache["conv"] = zeros(lead + shp[0], state_dtype, dev)
            cache["h"] = zeros(lead + shp[1], torch.float32, dev)
            if not kind["shared_attn"]:
                return cache
            s = max_len
        else:
            w = kind["window"]
            s = max_len if w is None else min(w, max_len)
        shape = lead + (batch, cfg.n_kv_heads, s, cfg.hd)
        cache["k"] = zeros(shape, dtype, dev)
        cache["v"] = zeros(shape, dtype, dev)
        return cache

    return {"blocks": {f"pos{j}": one(layer_kind(cfg, j), (n_blocks,))
                       for j in range(per)} if n_blocks > 0 else {},
            "rem": {f"rem{j}": one(layer_kind(cfg, j), ())
                    for j in range(n_rem)}}


def cache_layout(cfg: ArchConfig, batch: int, max_len: int, mesh,
                 data_axes=("data",), dtype=torch.float32) -> Tree:
    """``launch.shardings.cache_specs`` of the whole caches of
    :func:`init_caches` on ``mesh``: what each rank's block is (and what
    ``gather_leaf`` puts back together)."""
    from ..launch.shardings import cache_specs

    return cache_specs(init_caches(cfg, batch, max_len, dtype, "meta"), mesh,
                       batch, tuple(data_axes))


def _widen_conv_states(caches: Tree, dtype: torch.dtype) -> None:
    """Give every SSM conv state of ``caches`` (in place in the tree) the
    dtype its decode arithmetic promotes it to with activations of
    ``dtype``, as the reference's decode step returns it."""
    for group in caches.values():
        for cache in group.values():
            conv = cache.get("conv")
            if conv is not None:
                want = torch.promote_types(conv.dtype, dtype)
                if conv.dtype != want:
                    cache["conv"] = conv.to(want)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _write_prefill_cache(cache_kv: Tree, k_new: torch.Tensor,
                         v_new: torch.Tensor, slots=None) -> None:
    """Fill a KV cache in place from prefill K/V (B, Hkv, S, hd), cast as
    the reference casts; for a window-sized cache the last S_c positions
    land at their rolling slots ``pos % S_c``.  ``slots`` (s0, S_c): the
    cache is a rank's block of slots s0 .. s0 + its length - 1, and only
    the positions that land there are written."""
    s = k_new.shape[2]
    if slots is not None:
        s0, s_c = slots
        first = max(s - s_c, 0)                  # the positions kept
        slot = np.arange(first, s) % s_c - s0
        mine = (slot >= 0) & (slot < cache_kv["k"].shape[2])
        pos = torch.as_tensor(np.arange(first, s)[mine], device=k_new.device)
        index = (slice(None), slice(None),
                 torch.as_tensor(slot[mine], device=k_new.device))
        write_cache((cache_kv["k"], cache_kv["v"]), index,
                    (k_new[:, :, pos], v_new[:, :, pos]))
        return
    s_c = cache_kv["k"].shape[2]
    if s >= s_c:
        slots = torch.arange(s - s_c, s, device=k_new.device) % s_c
        index = (slice(None), slice(None), slots)
        k_new, v_new = k_new[:, :, s - s_c:], v_new[:, :, s - s_c:]
    else:
        index = (slice(None), slice(None), slice(0, s))
    write_cache((cache_kv["k"], cache_kv["v"]), index, (k_new, v_new))


def _prefill_kv(cfg: ArchConfig, ap: Tree, h: torch.Tensor,
                positions: torch.Tensor, cache: Tree, plain: bool,
                tp=None, cache_len: Optional[int] = None) -> None:
    """Write K/V into the prefill cache (rope'd, in decode's layout),
    recomputed from h as the JAX package does.  Over a model group ``tp``
    the rank writes its block of the cache of ``cache_len`` slots
    (``layers.kv_block``): its KV heads, or the whole K/V (gathered where
    ``wk`` / ``wv`` are split) at its slots."""
    b, s, _ = h.shape
    k = h @ ap["wk"]
    v = h @ ap["wv"]
    if cfg.qkv_bias:
        k, v = k + ap["bk"], v + ap["bv"]
    slots = None
    if tp is not None:
        heads, slots = kv_block(cache["k"], cfg, cache_len, tp)
        if not heads and k.shape[-1] != cfg.n_kv_heads * cfg.hd:
            k, v = gather_columns([k, v], tp)
    k = k.reshape(b, s, -1, cfg.hd)
    v = v.reshape(b, s, -1, cfg.hd)
    if cfg.qk_norm:
        k = rms_norm(k, ap["k_norm"], cfg.norm_eps, plain)
    k = rope(k, positions, cfg.rope_theta)
    _write_prefill_cache(cache, k.transpose(1, 2), v.transpose(1, 2), slots)


def _cache_len(kind, max_len: Optional[int]) -> Optional[int]:
    """The whole slot count of a layer's KV cache: min(window, max_len)
    for a local layer, max_len for a global one."""
    w = kind.get("window")
    if max_len is None or w is None:
        return max_len
    return min(w, max_len)


def _attn_mlp_layer(cfg: ArchConfig, kind, lp: Tree, x: torch.Tensor, *,
                    positions, cache, cache_pos, mode, impl, mesh=None,
                    data_axes=("data",), tp=None, max_len=None) -> tuple:
    """One attention + MLP (or MoE) layer: (x, aux), aux the router's
    load-balancing loss, None for a dense layer (the reference adds a zero
    aux there).  ``tp`` / ``mesh``: tensor and expert parallel (the module
    docstring); ``max_len`` the caches' whole length."""
    window = kind["window"]
    plain = impl == "ref"
    h = rms_norm(x, lp["ln1"], cfg.norm_eps, plain)
    cache_len = _cache_len(kind, max_len)
    if mode == "decode":
        attn_out, _ = attention_apply(
            lp["attn"], h, cfg, positions=positions, window=window,
            cache=(cache["k"], cache["v"]), cache_pos=cache_pos, impl=impl,
            tp=tp, cache_len=cache_len)
    else:
        attn_out, _ = attention_apply(lp["attn"], h, cfg, positions=positions,
                                      window=window, impl=impl, tp=tp)
        if mode == "prefill":
            _prefill_kv(cfg, lp["attn"], h, positions, cache, plain, tp,
                        cache_len)
    x = x + attn_out
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps, plain)
    if kind["type"] == "moe":
        moe_out, probs = moe.moe_apply(lp["moe"], h2, cfg, mesh=mesh,
                                       data_axes=data_axes)
        if cfg.shared_expert:
            sp = lp["shared_mlp"]
            moe_out = moe_out + mlp_apply(sp, h2, cfg.mlp_kind,
                                          _ff_group(tp, sp, cfg))
        return x + moe_out, moe.router_aux_loss(probs)
    return x + mlp_apply(lp["mlp"], h2, cfg.mlp_kind,
                         _ff_group(tp, lp["mlp"], cfg)), None


def _ff_group(tp, p: Tree, cfg: ArchConfig):
    """``tp`` where this rank holds a column block of the MLP ``p`` (its
    ``w_up`` narrower than d_ff), else None (the whole weights)."""
    return tp if tp is not None and p["w_up"].shape[-1] != cfg.d_ff else None


def _ssm_layer(cfg: ArchConfig, kind, lp: Tree, x: torch.Tensor, *,
               positions, cache, cache_pos, mode, impl,
               shared_params, **mesh_kw) -> tuple:
    """One SSM layer (norm + Mamba1 / Mamba2, residual), then the shared
    attention + MLP block where the kind says so: (x, None), an SSM layer
    having no aux.  Prefill and decode write the layer's states (and the
    shared block's K/V) into ``cache`` in place: over a model group the
    states in the cache's layout (``mamba``)."""
    plain = impl == "ref"
    mamba1 = kind["type"] == "mamba1"
    h = rms_norm(x, lp["ln"], cfg.norm_eps, plain)
    state = (cache["conv"], cache["h"]) if cache is not None else None
    tp = mesh_kw.get("tp")
    if mode == "decode":
        step = M.mamba1_step if mamba1 else M.mamba2_step
        y, (conv, hh) = step(lp["mamba"], h[:, 0, :], cfg, state, impl=impl,
                             tp=tp)
        y = y[:, None, :]
    else:
        apply = M.mamba1_apply if mamba1 else M.mamba2_apply
        y, (conv, hh) = apply(lp["mamba"], h, cfg, state, impl=impl, tp=tp)
    if mode != "train":
        cache["conv"].copy_(conv)
        cache["h"].copy_(hh)
    x = x + y
    if kind["shared_attn"]:
        # the shared block has a dense global layer's weights and steps
        x, _ = _attn_mlp_layer(cfg, {"type": "dense", "window": None},
                               shared_params, x, positions=positions,
                               cache=cache, cache_pos=cache_pos, mode=mode,
                               impl=impl, **mesh_kw)
    return x, None


def _apply_layer(cfg: ArchConfig, kind, lp: Tree, x: torch.Tensor, *,
                 shared_params, **kw) -> tuple:
    """The layer of ``kind``: (x, aux or None)."""
    if kind["type"] in SSM_TYPES:
        return _ssm_layer(cfg, kind, lp, x, shared_params=shared_params,
                          **kw)
    return _attn_mlp_layer(cfg, kind, lp, x, **kw)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

MODES = ("train", "train_hidden", "prefill", "decode")
TRAIN_MODES = ("train", "train_hidden")


def mesh_groups(mesh, data_axes=("data",)) -> tuple:
    """(model group or None, data group or None) of ``mesh`` for this
    rank: each None where its axes hold one rank (or no mesh)."""
    if mesh is None:
        return None, None
    tp = None
    if "model" in mesh.shape and mesh.shape["model"] > 1:
        tp = mesh.group("model")
    data = tuple(a for a in data_axes if a in mesh.shape)
    dg = mesh.group(data) if data and mesh.axis_size(data) > 1 else None
    return tp, dg


def vocab_range(cfg: ArchConfig, tp, n: int) -> Optional[tuple]:
    """(model group, first id, ids) of this rank's block of ``n``
    vocabulary ids where a table holds fewer than ``cfg.vocab`` (vocab-
    sharded over ``tp``), else None."""
    if tp is None or n == cfg.vocab:
        return None
    return tp, tp.index * n, n


def head_range(cfg: ArchConfig, params: Tree, tp) -> Optional[tuple]:
    """:func:`vocab_range` of the head's columns (``lm_head``, or the tied
    ``embed``'s rows)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return vocab_range(cfg, tp, head.shape[-1])


def forward(cfg: ArchConfig, params: Tree, tokens: torch.Tensor, *,
            mode: str = "train", caches: Optional[Tree] = None,
            pos: Optional[int] = None, impl: str = "flash",
            remat: bool = False,
            vision_embeds: Optional[torch.Tensor] = None,
            mesh=None, data_axes=("data",), max_len: Optional[int] = None,
            gather=None):
    """tokens (B, S) integer (S = 1 for decode, at absolute position
    ``pos``).  ``vision_embeds`` (B, Np, d), for a vision config in the
    train and prefill modes, are projected and prepended to the tokens'
    embeddings: positions then run over Np + S, and decode continues at
    ``pos`` >= Np + S.  See the module docstring for what each mode
    returns, and for ``mesh`` / ``data_axes``; ``max_len`` is the caches'
    whole length (``init_caches``), which prefill and decode over a model
    axis need to read a rank's block of a KV cache.  ``gather``
    (``launch.shardings.zero3_gather``): ``params`` hold ZeRO-3 blocks,
    and each layer's weights are gathered at use (the top-level ones once,
    at the start)."""
    check_supported(cfg)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    training = mode in TRAIN_MODES
    if mesh is not None and mesh.size == 1:
        mesh = None                     # the one-device path, bitwise
    tp, _ = mesh_groups(mesh, data_axes)
    if tp is not None and not training and max_len is None:
        raise ValueError(f"{mode!r} over a model axis needs max_len, the "
                         f"caches' whole length")
    if not training and caches is None:
        raise ValueError(f"mode {mode!r} needs caches (init_caches)")
    if remat and not training:
        raise ValueError("remat applies to the train modes only")
    per = pattern_period(cfg)
    kinds = [layer_kind(cfg, j) for j in range(per)]
    n_blocks, n_rem = divmod(cfg.n_layers, per)
    if gather is not None:
        params = {k: gather(v, (k,), layer=k != "blocks")
                  for k, v in params.items()}

    vocab = vocab_range(cfg, tp, params["embed"].shape[0])
    if vocab is None:
        x = params["embed"][tokens]
    else:
        # vocab-parallel: this rank's ids, zero rows elsewhere, summed
        group, v0, n = vocab
        local = tokens - v0
        mine = (local >= 0) & (local < n)
        x = torch.where(mine[..., None],
                        params["embed"][local.clamp(0, n - 1)], 0.0)
        x = D.reduce_from(x, group)
    if cfg.qk_norm:                          # gemma3 scales embeddings
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    if cfg.frontend == "vision" and vision_embeds is not None:
        if mode == "decode":
            raise ValueError("vision_embeds go to prefill or train, not to "
                             "a decode step")
        proj = params["vision_proj"]
        dt = torch.promote_types(vision_embeds.dtype, proj.dtype)
        vis = vision_embeds.to(dt) @ proj.to(dt)     # jnp's promotion
        if proj.shape[-1] != cfg.d_model:             # column-parallel
            vis = D.gather_from(vis, tp, dim=-1)
        x = torch.cat([vis.to(x.dtype), x], dim=1)   # early fusion
    s = x.shape[1]
    if mode == "decode":
        if pos is None:
            raise ValueError("decode needs pos")
        cache_pos = int(pos)
        _widen_conv_states(caches, x.dtype)
        positions = torch.tensor([cache_pos], dtype=torch.int32,
                                 device=x.device)
    else:
        cache_pos = None
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    kw = dict(positions=positions, cache_pos=cache_pos,
              mode="train" if training else mode, impl=impl,
              shared_params=params.get("shared_attn"))
    if mesh is not None:
        kw.update(mesh=mesh, data_axes=data_axes, tp=tp, max_len=max_len)

    def block(x_, aux_, i):
        """Repetition i of the layer pattern; aux_ plus its layers' aux."""
        for j in range(per):
            lp = _index(params["blocks"][f"pos{j}"], i)
            if gather is not None:
                lp = gather(lp, ("blocks", f"pos{j}"))
            cache = None if training else \
                _index(caches["blocks"][f"pos{j}"], i)
            x_, aj = _apply_layer(cfg, kinds[j], lp, x_, cache=cache, **kw)
            if aj is not None:
                aux_ = aux_ + aj
        return x_, aux_

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_blocks):
        if remat:
            x, aux = checkpoint(block, x, aux, i, use_reentrant=False)
        else:
            x, aux = block(x, aux, i)
    for j in range(n_rem):
        cache = None if training else caches["rem"][f"rem{j}"]
        x, aj = _apply_layer(cfg, kinds[j], params["rem"][f"rem{j}"], x,
                             cache=cache, **kw)
        if aj is not None:
            aux = aux + aj

    x = rms_norm(x, params["final_norm"], cfg.norm_eps, impl == "ref")
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if mode == "train_hidden":
        return x, head, aux
    if mode == "train":
        if head_range(cfg, params, tp) is not None:   # its vocab columns
            return D.copy_to(x, tp) @ head, aux
        return x @ head, aux
    # prefill / decode: only the last position's logits are needed
    logits = x[:, -1, :] @ head
    if mode == "prefill":
        return logits, caches, aux
    return logits, caches
