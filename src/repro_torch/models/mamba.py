"""Mamba1 (selective scan) and Mamba2 (SSD) blocks: the JAX package's
``models/mamba.py`` over torch tensors, with the same names, parameter
layouts and state shapes.

* mamba1: the recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``,
  ``y_t = C_t . h_t``, then the gate ``(y + D x) * silu(z)``.  The
  reference chunks the scan into a ``lax.associative_scan`` because the
  TPU has no recurrent kernel; here, on CUDA with ``impl="flash"``, scan
  and gate are one pass of K5 (``kernels.selective_scan``), in sequence
  mode and, at S = 1 from the cached state, in the decode step; on the CPU
  or with ``impl="ref"`` its plain version, a loop over the steps.
* mamba2: the SSD block decomposition (intra-chunk quadratic form, state
  passed between chunks), plain torch on either device, as the reference
  computes it outside any Pallas kernel.  Its gate norm is
  ``layers.rms_norm`` (K3 on CUDA unless ``impl="ref"``).  Each
  three-operand product of the reference is written as two two-operand
  ones, so that no (B, chunk, heads, head_dim, N) temporary is formed.

Both keep the reference's rule that a sequence longer than the chunk of
128 is a multiple of it (``ValueError`` here, ``assert`` there).  Each has
a one-token ``*_step`` for decode; its state is (conv_state, ssm_state).

**Tensor parallelism** (``tp``, the model group; the blocks
``launch.shardings.spec_for_param`` gives a rank).  x is replicated; the
column-parallel products take it through ``distributed.copy_to`` and
``out_proj`` (row-parallel) ends in ``distributed.reduce_from``.

* mamba1: a rank holds its d_inner / m channels of ``wx``, ``wz``,
  ``conv_w``, ``dt_w``, ``dt_b``, ``A_log``, ``D`` and rows of the
  row-parallel ``w_dt``, ``w_b``, ``w_c``: the dt low-rank input, B and C
  are sums of the ranks' parts that every rank then uses whole, so their
  collective sums in both directions (:func:`_psum_both`); the scan (K5)
  runs on the rank's channels.
* mamba2: a rank holds its heads of ``wx``, ``wz``, ``wdt``, ``dt_b``,
  ``A_log``, ``D``, ``gate_norm`` and ``out_proj``; ``wb`` / ``wc`` are
  whole and enter through ``copy_to``.  The conv weights split the
  concatenated [x | B | C] channels evenly, which is not the rank's heads'
  channels, so they are gathered (small) and the rank takes its x channels
  and all of B / C.  The gated RMSNorm normalises over the whole d_inner:
  the ranks' sums of squares are summed (both directions) and K3 / K3b
  (``rms_norm(..., ss=, n=)``) normalise the rank's block by them.  Where
  the heads do not divide the axis, the split leaves are gathered and
  every rank computes the whole block.

The states come in the cache's layout (``cache_specs``: the conv states
and mamba1's ``h`` whole, mamba2's ``h`` split over heads where they
divide) and go back in it: a rank computes its channels' part, and a whole
leaf is gathered after the step.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import distributed as D
from ..configs.base import ArchConfig
from ..kernels.selective_scan.ops import selective_scan
from ..kernels.selective_scan.ref import CHUNK, selective_scan_gated_ref
from .layers import dense_init, rms_norm, zeros

__all__ = ["CHUNK", "init_mamba1", "init_mamba2", "mamba1_apply",
           "mamba1_step", "mamba2_apply", "mamba2_step",
           "mamba1_state_shape", "mamba2_state_shape"]

Params = Dict[str, torch.Tensor]
State = Tuple[torch.Tensor, torch.Tensor]


def _chunk(s: int) -> int:
    """The reference's chunk, min(128, s); raises unless it divides s."""
    chunk = min(CHUNK, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the SSM "
                         f"chunk {chunk}")
    return chunk


# ---------------------------------------------------------------------------
# causal depthwise conv (shared by both)
# ---------------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor]) -> State:
    """x: (B, S, C); w: (K, C); state: (B, K-1, C) trailing inputs or None.
    Returns (y (B, S, C), new_state (B, K-1, C)): the reference's sum of K
    shifted products, in its order."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)                     # (B, S+K-1, C)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    y = y + b
    new_state = xp[:, -(k - 1):, :] if k > 1 else state
    return y, new_state


def _conv_step(x1: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               state: torch.Tensor) -> State:
    """Single-token conv.  x1: (B, C); state: (B, K-1, C)."""
    xp = torch.cat([state, x1[:, None, :]], dim=1)         # (B, K, C)
    y = (xp * w).sum(1) + b
    return y, xp[:, 1:, :]


def _psum_both(y: torch.Tensor, tp) -> torch.Tensor:
    """The sum over ``tp`` of the ranks' partial ``y``, which every rank
    then uses whole but differentiates only for its own channels: a
    ``psum`` forward whose backward is a ``psum`` (``reduce_from`` then
    ``copy_to``)."""
    return D.copy_to(D.reduce_from(y, tp), tp)


def _block(x: torch.Tensor, dim: int, n: int, tp) -> torch.Tensor:
    """This rank's block of ``n`` along ``dim`` of the whole ``x``."""
    return x.narrow(dim, tp.index * n, n).contiguous()


# ---------------------------------------------------------------------------
# mamba1
# ---------------------------------------------------------------------------

def init_mamba1(generator: Optional[torch.Generator], cfg: ArchConfig, dtype,
                device, lead: Tuple[int, ...] = ()) -> Params:
    """The reference's mamba1 weights; ``A_log`` and ``D`` fp32 whatever
    ``dtype`` (exp-sensitive), ``A_log = log(1..N)`` per channel."""
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    lead = tuple(lead)
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return {
        "wx": dense_init(generator, d, di, dtype, device, lead),
        "wz": dense_init(generator, d, di, dtype, device, lead),
        "conv_w": dense_init(generator, cfg.ssm_conv, di, dtype, device,
                             lead).mul_(0.5),
        "conv_b": zeros(lead + (di,), dtype, device),
        "w_dt": dense_init(generator, di, r, dtype, device, lead),
        "w_b": dense_init(generator, di, n, dtype, device, lead),
        "w_c": dense_init(generator, di, n, dtype, device, lead),
        "dt_w": dense_init(generator, r, di, dtype, device, lead),
        "dt_b": torch.full(lead + (di,), -4.6, dtype=dtype, device=device),
        "A_log": torch.log(a).expand(lead + (di, n)).contiguous(),
        "D": torch.ones(lead + (di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(generator, di, d, dtype, device, lead),
    }


def _m1_split(p: Params, cfg: ArchConfig, tp):
    """``tp`` where this rank holds a block of mamba1's d_inner channels
    (every split leaf is split over them), else None."""
    return tp if tp is not None and p["wx"].shape[-1] != cfg.d_inner \
        else None


def _m1_state_in(state: Optional[State], cfg: ArchConfig, tp, di: int):
    """This rank's channels of a state in the cache's layout."""
    conv, h = state if state is not None else (None, None)
    if tp is not None and conv is not None and conv.shape[-1] == cfg.d_inner:
        conv = _block(conv, -1, di, tp)
    if tp is not None and h is not None and h.shape[1] == cfg.d_inner:
        h = _block(h, 1, di, tp)
    return conv, h


def _m1_state_out(state: Optional[State], new: State, cfg: ArchConfig,
                  tp) -> State:
    """The rank's new states back in ``state``'s layout (gathered where
    it is whole)."""
    if tp is None or state is None:
        return new
    conv, h = new
    if state[0].shape[-1] == cfg.d_inner:
        conv = D.gather_from(conv, tp, dim=-1)
    if state[1].shape[1] == cfg.d_inner:
        h = D.gather_from(h, tp, dim=1)
    return conv, h


def _m1_inputs(p: Params, x: torch.Tensor, tp, conv_state, step: bool):
    """The scan's inputs from x (B, S, d) or, with ``step``, (B, d): (dt,
    xc, B, C, z, new conv state) over this rank's channels."""
    xi = D.copy_to(x, tp) if tp is not None else x
    xin = xi @ p["wx"]
    z = xi @ p["wz"]
    conv = _conv_step if step else _causal_conv
    xc, conv_state = conv(xin, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    low, bmat, cmat = xc @ p["w_dt"], xc @ p["w_b"], xc @ p["w_c"]
    if tp is not None:                 # row-parallel: the ranks' parts
        widths = [t.shape[-1] for t in (low, bmat, cmat)]
        low, bmat, cmat = _psum_both(torch.cat([low, bmat, cmat], dim=-1),
                                     tp).split(widths, dim=-1)
    dt = F.softplus(low @ p["dt_w"] + p["dt_b"].float())
    # K5 takes B / C rows of unit stride (a split of the sum is a view)
    return (dt, xc, bmat.float().contiguous(), cmat.float().contiguous(), z,
            conv_state)


def mamba1_apply(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 state: Optional[State] = None,
                 impl: str = "flash", tp=None) -> Tuple[torch.Tensor, State]:
    """Sequence-mode mamba1.  x: (B, S, d).  state: (conv_state, h) or
    None.  Returns (y (B, S, d), new_state).  The scan and its gate are K5
    on CUDA unless ``impl="ref"``.  ``tp``: tensor parallel over d_inner
    (the module docstring)."""
    bsz, s, _ = x.shape
    tp = _m1_split(p, cfg, tp)
    di, n = p["wx"].shape[-1], cfg.ssm_state
    conv_state, h0 = _m1_state_in(state, cfg, tp, di)
    dt, xc, bmat, cmat, z, conv_state = _m1_inputs(p, x, tp, conv_state,
                                                   False)
    a = -torch.exp(p["A_log"])                             # (di, N)
    if h0 is None:
        h0 = torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
    _chunk(s)
    scan = selective_scan_gated_ref if impl == "ref" else selective_scan
    y, h_last = scan(dt, xc.float(), bmat, cmat, a, h0, p["D"], z.float())
    y = y.to(x.dtype) @ p["out_proj"]
    if tp is not None:
        y = D.reduce_from(y, tp)
    return y, _m1_state_out(state, (conv_state, h_last), cfg, tp)


def mamba1_step(p: Params, x1: torch.Tensor, cfg: ArchConfig, state: State,
                impl: str = "flash", tp=None) -> Tuple[torch.Tensor, State]:
    """Single-token decode.  x1: (B, d); state = (conv (B, K-1, di),
    h (B, di, N)).  The recurrence and the gate are the sequence scan at
    S = 1 from ``h`` (K5 on CUDA unless ``impl="ref"``)."""
    tp = _m1_split(p, cfg, tp)
    di = p["wx"].shape[-1]
    conv_state, h = _m1_state_in(state, cfg, tp, di)
    dt, xc, bmat, cmat, z, conv_state = _m1_inputs(p, x1, tp, conv_state,
                                                   True)
    a = -torch.exp(p["A_log"])
    scan = selective_scan_gated_ref if impl == "ref" else selective_scan
    y, h = scan(dt[:, None], xc.float()[:, None], bmat[:, None],
                cmat[:, None], a, h, p["D"], z.float()[:, None])
    y = y[:, 0].to(x1.dtype) @ p["out_proj"]
    if tp is not None:
        y = D.reduce_from(y, tp)
    return y, _m1_state_out(state, (conv_state, h), cfg, tp)


def mamba1_state_shape(cfg: ArchConfig, batch: int):
    return ((batch, cfg.ssm_conv - 1, cfg.d_inner),
            (batch, cfg.d_inner, cfg.ssm_state))


# ---------------------------------------------------------------------------
# mamba2 (SSD)
# ---------------------------------------------------------------------------

def init_mamba2(generator: Optional[torch.Generator], cfg: ArchConfig, dtype,
                device, lead: Tuple[int, ...] = ()) -> Params:
    """The reference's mamba2 weights; ``dt_b``, ``A_log`` (A = -1) and
    ``D`` fp32 whatever ``dtype``."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    conv_dim = di + 2 * n
    lead = tuple(lead)
    f32 = torch.float32
    return {
        "wz": dense_init(generator, d, di, dtype, device, lead),
        "wx": dense_init(generator, d, di, dtype, device, lead),
        "wb": dense_init(generator, d, n, dtype, device, lead),
        "wc": dense_init(generator, d, n, dtype, device, lead),
        "wdt": dense_init(generator, d, nh, dtype, device, lead),
        "conv_w": dense_init(generator, cfg.ssm_conv, conv_dim, dtype,
                             device, lead).mul_(0.5),
        "conv_b": zeros(lead + (conv_dim,), dtype, device),
        "dt_b": torch.full(lead + (nh,), -4.6, dtype=f32, device=device),
        "A_log": zeros(lead + (nh,), f32, device),
        "D": torch.ones(lead + (nh,), dtype=f32, device=device),
        "gate_norm": zeros(lead + (di,), dtype, device),
        "out_proj": dense_init(generator, di, d, dtype, device, lead),
    }


# leaf -> the dim spec_for_param splits (of the unstacked leaf)
_M2_SPLIT = {"wz": -1, "wx": -1, "wdt": -1, "conv_w": -1, "conv_b": -1,
             "dt_b": -1, "A_log": -1, "D": -1, "gate_norm": -1,
             "out_proj": -2}


def _m2_view(p: Params, cfg: ArchConfig, tp):
    """(the weights this rank computes with, its heads' group or None, the
    group of its split leaves or None).  With the heads split: its heads'
    leaves, ``wb`` / ``wc`` through ``copy_to``, and the conv weights of
    its x channels plus all of B / C, taken from the whole (gathered) conv
    weights through ``copy_to``.  With split leaves but heads that do not
    divide the axis: every split leaf gathered, no heads' group."""
    di, n = cfg.d_inner, cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    whole = {"wz": di, "wx": di, "wdt": nh, "conv_w": di + 2 * n,
             "conv_b": di + 2 * n, "dt_b": nh, "A_log": nh, "D": nh,
             "gate_norm": di, "out_proj": di}
    if tp is None or all(p[k].shape[d] == whole[k]
                         for k, d in _M2_SPLIT.items()):
        return p, None, None
    if p["wdt"].shape[-1] == nh:
        return {k: D.gather_from(v, tp, dim=_M2_SPLIT[k])
                if k in _M2_SPLIT and v.shape[_M2_SPLIT[k]] != whole[k]
                else v for k, v in p.items()}, None, tp
    q = dict(p)
    q["wb"], q["wc"] = D.copy_to(p["wb"], tp), D.copy_to(p["wc"], tp)
    dl = p["wx"].shape[-1]
    c0 = tp.index * dl
    for k in ("conv_w", "conv_b"):
        w = p[k]
        if w.shape[-1] != whole[k]:
            w = D.gather_from(w, tp, dim=-1)
        w = D.copy_to(w, tp)
        q[k] = torch.cat([w[..., c0:c0 + dl], w[..., di:]], dim=-1)
    return q, tp, tp


def _h_split_dim(h: torch.Tensor, cfg: ArchConfig) -> Optional[int]:
    """The dim over which a block ``h`` (B, nh, hd, N) of mamba2's state is
    split (heads 1, else head_dim 2), None where it is whole."""
    nh = cfg.d_inner // cfg.ssm_head_dim
    if h.shape[1] != nh:
        return 1
    return 2 if h.shape[2] != cfg.ssm_head_dim else None


def _m2_state_in(state: Optional[State], cfg: ArchConfig, heads, group,
                 dl: int, nhl: int):
    """This rank's part of a state in the cache's layout: with its heads'
    group, the conv state of its x channels and B / C and its heads of
    ``h``; else the whole states (a split ``h`` gathered)."""
    conv, h = state if state is not None else (None, None)
    di = cfg.d_inner
    if h is not None and heads is None and group is not None:
        dim = _h_split_dim(h, cfg)
        if dim is not None:
            h = D.gather_from(h, group, dim=dim)
    if heads is None:
        return conv, h
    if conv is not None:
        c0 = heads.index * dl
        conv = torch.cat([conv[..., c0:c0 + dl], conv[..., di:]], dim=-1)
    if h is not None and _h_split_dim(h, cfg) is None:
        h = _block(h, 1, nhl, heads)
    return conv, h


def _m2_state_out(state: Optional[State], new: State, cfg: ArchConfig,
                  heads, group, dl: int) -> State:
    """The new states back in ``state``'s layout: the conv state's x
    channels gathered beside B / C, ``h`` gathered where it is whole, or
    cut to the rank's block where the rank computed it whole."""
    if state is None or group is None:
        return new
    conv, h = new
    dim = _h_split_dim(state[1], cfg)
    if heads is None:
        if dim is not None:
            h = _block(h, dim, state[1].shape[dim], group)
        return conv, h
    conv = torch.cat([D.gather_from(conv[..., :dl], heads, dim=-1),
                      conv[..., dl:]], dim=-1)
    if dim is None:
        h = D.gather_from(h, heads, dim=1)
    return conv, h


def _gate_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
               cfg: ArchConfig, dtype, plain: bool, tp) -> torch.Tensor:
    """``rms_norm((y * silu(z)).to(dtype), scale)`` over the whole
    d_inner: with ``tp`` the rank holds a block of it, and K3 normalises
    it by the ranks' sums of squares, summed (both directions)."""
    g = (y * F.silu(z.float())).to(dtype)
    if tp is None:
        return rms_norm(g, scale, cfg.norm_eps, plain)
    ss = _psum_both(g.float().square().sum(-1), tp)
    return rms_norm(g, scale, cfg.norm_eps, plain, ss=ss, n=cfg.d_inner)


def mamba2_apply(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 state: Optional[State] = None,
                 impl: str = "flash", tp=None) -> Tuple[torch.Tensor, State]:
    """Sequence-mode SSD.  x: (B, S, d).  state = (conv_state,
    h (B, nh, hd, N)) or None.  ``tp``: tensor parallel over the heads
    (the module docstring)."""
    bsz, s, _ = x.shape
    p, tp, group = _m2_view(p, cfg, tp)
    di, n, hd = p["wx"].shape[-1], cfg.ssm_state, cfg.ssm_head_dim
    nh = di // hd
    conv_state, h = _m2_state_in(state, cfg, tp, group, di, nh)

    xi = D.copy_to(x, tp) if tp is not None else x
    z = xi @ p["wz"]                                       # (B, S, di)
    xbc = torch.cat([xi @ p["wx"], xi @ p["wb"], xi @ p["wc"]], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :di]
    bmat = xbc[..., di:di + n].float()                     # (B, S, N)
    cmat = xbc[..., di + n:].float()                       # (B, S, N)
    dt = F.softplus((xi @ p["wdt"]).float() + p["dt_b"])   # (B, S, nh)
    a = -torch.exp(p["A_log"])                             # (nh,)

    xh = xs.reshape(bsz, s, nh, hd).float()
    if h is None:
        h = torch.zeros((bsz, nh, hd, n), dtype=torch.float32,
                        device=x.device)
    chunk = _chunk(s)
    future = torch.triu(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device), diagonal=1)
    ys = []
    for lo in range(0, s, chunk):
        xq, bq, cq, dtq = (t[:, lo:lo + chunk] for t in (xh, bmat, cmat, dt))
        cum = torch.cumsum(dtq * a, dim=1)                 # (B, Q, nh)
        # intra-chunk quadratic form: M[q,k] = C_q.B_k exp(cum_q - cum_k)
        qk = torch.einsum("bqn,bkn->bqk", cq, bq)          # (B, Q, Q)
        ldiff = cum[:, :, None, :] - cum[:, None, :, :]    # (B, Q, K, nh)
        # masked before the exp, where the reference masks after it: the
        # same values, but once a chunk's decays pass exp's range (~88)
        # the reference's gradient is 0 * inf = NaN and this one is finite
        m = torch.exp(torch.where(future[None, :, :, None], -torch.inf,
                                  ldiff))
        m = m * qk[:, :, :, None]
        xdt = xq * dtq[..., None]                          # (B, K, nh, hd)
        y_intra = torch.einsum("bqkh,bkhd->bqhd", m, xdt)
        # inter-chunk: the carried state's contribution
        y_inter = torch.einsum("bqn,bhdn->bqhd", cq, h) \
            * torch.exp(cum)[..., None]
        # new state: the reference's "bkhd,bkn,bkh->bhdn" as xdt * wgt first
        wgt = torch.exp(cum[:, -1:, :] - cum)              # (B, Q, nh)
        h = torch.exp(cum[:, -1])[:, :, None, None] * h + torch.einsum(
            "bkhd,bkn->bhdn", xdt * wgt[..., None], bq)
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)                               # (B, S, nh, hd)
    y = y + p["D"][:, None] * xh
    y = y.reshape(bsz, s, di)
    y = _gate_norm(y, z, p["gate_norm"], cfg, x.dtype, impl == "ref", tp)
    y = y @ p["out_proj"]
    if tp is not None:
        y = D.reduce_from(y, tp)
    return y, _m2_state_out(state, (conv_state, h), cfg, tp, group, di)


def mamba2_step(p: Params, x1: torch.Tensor, cfg: ArchConfig, state: State,
                impl: str = "flash", tp=None) -> Tuple[torch.Tensor, State]:
    """Single-token decode.  x1: (B, d)."""
    p, tp, group = _m2_view(p, cfg, tp)
    di, n, hd = p["wx"].shape[-1], cfg.ssm_state, cfg.ssm_head_dim
    nh = di // hd
    conv_state, h = _m2_state_in(state, cfg, tp, group, di, nh)
    xi = D.copy_to(x1, tp) if tp is not None else x1
    z = xi @ p["wz"]
    xbc = torch.cat([xi @ p["wx"], xi @ p["wb"], xi @ p["wc"]], dim=-1)
    xbc, conv_state = _conv_step(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :di].reshape(-1, nh, hd).float()
    bmat = xbc[..., di:di + n].float()
    cmat = xbc[..., di + n:].float()
    dt = F.softplus((xi @ p["wdt"]).float() + p["dt_b"])
    a = -torch.exp(p["A_log"])
    decay = torch.exp(dt * a)                              # (B, nh)
    # the reference's "bhd,bn,bh->bhdn" as (xs dt) first, then B
    h = decay[:, :, None, None] * h \
        + (xs * dt[..., None])[..., None] * bmat[:, None, None, :]
    y = torch.einsum("bhdn,bn->bhd", h, cmat) + p["D"][:, None] * xs
    y = y.reshape(-1, di)
    y = _gate_norm(y, z, p["gate_norm"], cfg, x1.dtype, impl == "ref", tp)
    y = y @ p["out_proj"]
    if tp is not None:
        y = D.reduce_from(y, tp)
    return y, _m2_state_out(state, (conv_state, h), cfg, tp, group, di)


def mamba2_state_shape(cfg: ArchConfig, batch: int):
    nh = cfg.d_inner // cfg.ssm_head_dim
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return ((batch, cfg.ssm_conv - 1, conv_dim),
            (batch, nh, cfg.ssm_head_dim, cfg.ssm_state))
