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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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


def mamba1_apply(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 state: Optional[State] = None,
                 impl: str = "flash") -> Tuple[torch.Tensor, State]:
    """Sequence-mode mamba1.  x: (B, S, d).  state: (conv_state, h) or
    None.  Returns (y (B, S, d), new_state).  The scan and its gate are K5
    on CUDA unless ``impl="ref"``."""
    bsz, s, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    conv_state, h0 = state if state is not None else (None, None)

    xin = x @ p["wx"]                                      # (B, S, di)
    z = x @ p["wz"]
    xc, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    dt = F.softplus((xc @ p["w_dt"]) @ p["dt_w"]
                    + p["dt_b"].float())                   # (B, S, di)
    bmat = (xc @ p["w_b"]).float()                         # (B, S, N)
    cmat = (xc @ p["w_c"]).float()
    a = -torch.exp(p["A_log"])                             # (di, N)

    if h0 is None:
        h0 = torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
    _chunk(s)
    scan = selective_scan_gated_ref if impl == "ref" else selective_scan
    y, h_last = scan(dt, xc.float(), bmat, cmat, a, h0, p["D"], z.float())
    return y.to(x.dtype) @ p["out_proj"], (conv_state, h_last)


def mamba1_step(p: Params, x1: torch.Tensor, cfg: ArchConfig, state: State,
                impl: str = "flash") -> Tuple[torch.Tensor, State]:
    """Single-token decode.  x1: (B, d); state = (conv (B, K-1, di),
    h (B, di, N)).  The recurrence and the gate are the sequence scan at
    S = 1 from ``h`` (K5 on CUDA unless ``impl="ref"``)."""
    conv_state, h = state
    xin = x1 @ p["wx"]
    z = x1 @ p["wz"]
    xc, conv_state = _conv_step(xin, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    dt = F.softplus((xc @ p["w_dt"]) @ p["dt_w"]
                    + p["dt_b"].float())                   # (B, di)
    bmat = (xc @ p["w_b"]).float()                         # (B, N)
    cmat = (xc @ p["w_c"]).float()
    a = -torch.exp(p["A_log"])
    scan = selective_scan_gated_ref if impl == "ref" else selective_scan
    y, h = scan(dt[:, None], xc.float()[:, None], bmat[:, None],
                cmat[:, None], a, h, p["D"], z.float()[:, None])
    return y[:, 0].to(x1.dtype) @ p["out_proj"], (conv_state, h)


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


def mamba2_apply(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 state: Optional[State] = None,
                 impl: str = "flash") -> Tuple[torch.Tensor, State]:
    """Sequence-mode SSD.  x: (B, S, d).  state = (conv_state,
    h (B, nh, hd, N)) or None."""
    bsz, s, _ = x.shape
    di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    nh = di // hd
    conv_state, h = state if state is not None else (None, None)

    z = x @ p["wz"]                                        # (B, S, di)
    xbc = torch.cat([x @ p["wx"], x @ p["wb"], x @ p["wc"]], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :di]
    bmat = xbc[..., di:di + n].float()                     # (B, S, N)
    cmat = xbc[..., di + n:].float()                       # (B, S, N)
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_b"])    # (B, S, nh)
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
    y = rms_norm((y * F.silu(z.float())).to(x.dtype), p["gate_norm"],
                 cfg.norm_eps, impl == "ref")
    return y @ p["out_proj"], (conv_state, h)


def mamba2_step(p: Params, x1: torch.Tensor, cfg: ArchConfig, state: State,
                impl: str = "flash") -> Tuple[torch.Tensor, State]:
    """Single-token decode.  x1: (B, d)."""
    conv_state, h = state
    di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    nh = di // hd
    z = x1 @ p["wz"]
    xbc = torch.cat([x1 @ p["wx"], x1 @ p["wb"], x1 @ p["wc"]], dim=-1)
    xbc, conv_state = _conv_step(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :di].reshape(-1, nh, hd).float()
    bmat = xbc[..., di:di + n].float()
    cmat = xbc[..., di + n:].float()
    dt = F.softplus((x1 @ p["wdt"]).float() + p["dt_b"])
    a = -torch.exp(p["A_log"])
    decay = torch.exp(dt * a)                              # (B, nh)
    # the reference's "bhd,bn,bh->bhdn" as (xs dt) first, then B
    h = decay[:, :, None, None] * h \
        + (xs * dt[..., None])[..., None] * bmat[:, None, None, :]
    y = torch.einsum("bhdn,bn->bhd", h, cmat) + p["D"][:, None] * xs
    y = y.reshape(-1, di)
    y = rms_norm((y * F.silu(z.float())).to(x1.dtype), p["gate_norm"],
                 cfg.norm_eps, impl == "ref")
    return y @ p["out_proj"], (conv_state, h)


def mamba2_state_shape(cfg: ArchConfig, batch: int):
    nh = cfg.d_inner // cfg.ssm_head_dim
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return ((batch, cfg.ssm_conv - 1, conv_dim),
            (batch, nh, cfg.ssm_head_dim, cfg.ssm_state))
