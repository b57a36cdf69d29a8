"""Plain PyTorch versions of flash attention and its gradient: dense masked
softmax in fp32, the JAX package's ``kernels/flash_attention/ref.py`` in
the same layout; the gradient is what ``jax.grad`` of it computes, written
out from the forward's output and per-row log-sum-exp."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _acc(x: torch.Tensor) -> torch.dtype:
    """fp32, or float64 for float64 inputs (the gradient checks)."""
    return torch.promote_types(x.dtype, torch.float32)


def _scores(q, k, *, causal, window, scale, q_offset):
    """Scaled scores (B, Hq, Tq, Tk) with K repeated over each GQA group,
    the mask (Tq, Tk), and the repeat count."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    groups = hq // hkv
    acc = _acc(q)
    kr = k.repeat_interleave(groups, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), kr.to(acc)) * scale
    qpos = q_offset + torch.arange(tq, device=q.device)[:, None]
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    return s, mask, groups


def attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      scale: float | None = None,
                      q_offset: int = 0) -> tuple:
    """:func:`attention_ref` and each row's log-sum-exp of its scaled live
    scores, ``m + log(max(l, 1e-30))`` (B, Hq, Tq) in fp32 (float64 for
    float64 inputs): K4's L, ~ -1e30 for a row with no live key."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    s, mask, groups = _scores(q, k, causal=causal, window=window,
                              scale=scale, q_offset=q_offset)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(mask, p, 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    p = p / l
    vr = v.repeat_interleave(groups, dim=1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr.to(p.dtype))
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, Tq, D), k / v (B, Hkv, Tk, D) -> (B, Hq, Tq, D) in q's
    dtype.  Query head h reads KV head ``h // (Hq // Hkv)``.  ``q_offset``
    places the queries at absolute positions [q_offset, q_offset + Tq)
    against keys at [0, Tk)."""
    return attention_fwd_ref(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset)[0]


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      scale: float | None = None) -> tuple:
    """The gradient of :func:`attention_ref` for the output gradient
    ``do``, from its output ``o`` and log-sum-exp ``lse``
    (:func:`attention_fwd_ref`), by the formulas K4b computes:
    ``P = exp(S - lse)`` where live, ``dS = P (dO V^T - rowsum(dO o))``,
    ``dQ = scale dS K``, ``dK = scale dS^T Q``, ``dV = P^T dO``, dK and dV
    summed over each GQA group.  Returns (dq, dk, dv) in the inputs'
    dtypes."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s, mask, groups = _scores(q, k, causal=causal, window=window,
                              scale=scale, q_offset=0)
    acc = s.dtype
    p = torch.where(mask, torch.exp(s - lse.to(acc)[..., None]), 0.0)
    qf, dof = q.to(acc), do.to(acc)
    kr = k.repeat_interleave(groups, dim=1).to(acc)
    vr = v.repeat_interleave(groups, dim=1).to(acc)
    delta = (dof * o.to(acc)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vr) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(b, hkv, groups, tk, d).sum(2)
    dv = dv.reshape(b, hkv, groups, tk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
