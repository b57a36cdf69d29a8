"""The port's LM training path against the JAX package, on the CPU.

The same numpy inputs, and the JAX package's own parameters (carried across
by ``convert.params_from_jax``), go through both.  JAX trains as its own
tests train: autodiff of the plain jnp model.  On the CPU the port's kernel
Functions take their plain versions (K3 / K3b: ``rmsnorm_ref`` /
``rmsnorm_bwd_ref``; K4 / K4b: ``attention_fwd_ref`` /
``attention_bwd_ref``; K5 / K5b: ``selective_scan_gated_ref`` /
``selective_scan_bwd_ref``); the kernels are held to those on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  The models are the
dense, MoE, Mamba1 (falcon-mamba-7b) and hybrid Mamba2 (zamba2-7b)
families at smoke size.

Tolerances, with their reasons:
  * Plain backward versions against ``jax.grad``: |diff| <= 1e-5 x max(1,
    max |want|) (fp32 products and sums in another order).
  * ``train_step``: loss and grad norm rtol 1e-5; mu and nu (the
    gradients' first and second moments) rtol 1e-4 (the deep-Q parity's),
    atol 1e-5 x the leaf's max |want|; params rtol 1e-4, atol 0.1 lr =
    1e-4: AdamW divides g by |g| + eps, so an element whose gradient is
    within a few eps of zero moves by a fraction of lr when the gradient's
    last bits do (worst measured: 2.6e-5, one element of 2,048 in a
    gemma3 smoke leaf; the rest within 1e-5).  zamba2-7b's mu and nu:
    atol 5e-5 x the leaf's max, for the reason and the measurement given
    at ``test_train_step_matches_jax``.
  * Equivalences (microbatches, remat, chunked CE) of the port with
    itself: as the JAX package's ``tests/test_train_substrate.py``.
"""
import dataclasses
import functools
import gc
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.models import layers as JL
from repro.train import train_step as JT
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import warmup_cosine as jwarmup_cosine

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref)
from repro_torch.kernels.rmsnorm import kernel as rn_kernel
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.train import train_step as TT
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         tree_leaves, tree_like,
                                         warmup_cosine)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    top = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * top, (err, tol * top)


# --- plain backward versions against jax.grad --------------------------------

@pytest.mark.parametrize("shape", [(7, 64), (3, 5, 256), (2, 4, 3, 16)])
def test_rmsnorm_bwd_ref_matches_jax_grad(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(0, 2, shape).astype(np.float32)
    s = rng.normal(0, 0.1, shape[-1:]).astype(np.float32)
    g = rng.normal(0, 1, shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, s_: JL.rms_norm(x_, s_, 1e-6),
                     jnp.asarray(x), jnp.asarray(s))
    jdx, jds = vjp(jnp.asarray(g))
    dx, ds = rmsnorm_bwd_ref(_t(x), _t(s), _t(g), 1e-6)
    close(dx, jdx)
    close(ds, jds)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_variant_choice(dtype):
    """Which K3b variant a shape and the alignment of x and g take (decided
    on the host before the launch, so it is checked here on CPU tensors):
    "warp" (or "block" past D_MAX) only when the rows of both are 16-byte
    aligned."""
    epv = 16 // torch.empty((), dtype=dtype).element_size()
    dmax = rn_kernel.D_MAX

    def view(rows, d, offset=0, ld=None):
        ld = d if ld is None else ld
        buf = torch.zeros(rows * ld + offset, dtype=dtype)
        assert buf.data_ptr() % 16 == 0
        return buf[offset:].view(rows, ld)[:, :d]

    def pick(rows, d, x_off=0, g_off=0, x_ld=None, g_ld=None):
        s = torch.zeros(d, dtype=dtype)
        return rn_kernel.variant(view(rows, d, x_off, x_ld), s,
                                     view(rows, d, g_off, g_ld))

    assert pick(4096, 1152) == ("warp", -(-1152 // (32 * epv)))
    assert pick(16384, 256) == ("warp", -(-256 // (32 * epv)))
    assert pick(9, dmax) == ("warp", dmax // (32 * epv))
    assert pick(9, dmax + epv) == (
        "block", -(-(dmax // epv + 1) // (32 * rn_kernel.BWD_BLOCK_WARPS)))
    assert pick(9, 1152, x_off=1) == ("scalar", 0)
    assert pick(9, 1152, g_off=1) == ("scalar", 0)
    assert pick(9, 256, g_ld=301) == ("scalar", 0)
    assert pick(9, 1150) == ("scalar", 0)
    assert pick(9, dmax + 1) == ("scalar", 0)


SELF_CASES = [   # self-attention: (B, Hq, Hkv, T, D, window)
    (2, 4, 4, 20, 16, None),          # causal
    (1, 4, 1, 33, 8, 7),              # GQA 4:1, window
    (2, 6, 2, 17, 16, 4),             # GQA 3:1, window
]


@pytest.mark.parametrize("case", SELF_CASES)
def test_attention_bwd_ref_matches_jax_grad_of_masked_attention(case):
    """Self-attention as the model runs it: the gradient of the JAX
    package's ``_masked_attention`` (what its training path
    differentiates)."""
    b, hq, hkv, t, d, window = case
    rng = np.random.default_rng(t * d)
    q, do = (rng.normal(0, 1, (b, hq, t, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(0, 1, (b, hkv, t, d)).astype(np.float32)
            for _ in range(2))
    pos = jnp.arange(t, dtype=jnp.int32)

    def f(q_, k_, v_):
        return JL._masked_attention(q_, k_, v_, causal_from=pos,
                                    kv_valid=jnp.broadcast_to(pos, (b, t)),
                                    window=window)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    o, lse = attention_fwd_ref(_t(q), _t(k), _t(v), window=window)
    got = attention_bwd_ref(_t(q), _t(k), _t(v), o, lse, _t(do),
                            window=window)
    for g_, w_ in zip(got, want):
        close(g_, w_)


KERNEL_CASES = [   # (B, Hq, Hkv, Tq, Tk, D, causal, window)
    (1, 2, 1, 9, 23, 8, False, None),     # ragged Tk, not causal
    (1, 4, 2, 40, 12, 8, True, 6),        # rows 17.. see no key at all
    (2, 2, 2, 16, 16, 4, True, None),
]


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_attention_bwd_ref_matches_jax_grad_of_the_kernel_reference(case):
    """Shapes self-attention never gives (Tq != Tk, fully masked rows):
    the gradient of the JAX package's flash-attention reference, which
    zeroes masked p as K4 does; a fully masked row gets a zero gradient."""
    b, hq, hkv, tq, tk, d, causal, window = case
    rng = np.random.default_rng(tq * tk)
    q, do = (rng.normal(0, 1, (b, hq, tq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(0, 1, (b, hkv, tk, d)).astype(np.float32)
            for _ in range(2))
    _, vjp = jax.vjp(lambda q_, k_, v_: jattention_ref(
        q_, k_, v_, causal=causal, window=window),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    kw = dict(causal=causal, window=window)
    o, lse = attention_fwd_ref(_t(q), _t(k), _t(v), **kw)
    got = attention_bwd_ref(_t(q), _t(k), _t(v), o, lse, _t(do), **kw)
    for g_, w_ in zip(got, want):
        close(g_, w_)
    if window is not None and tq > tk + window:
        assert float(lse[:, :, tk + window:].max()) < -1e29
        assert not got[0][:, :, tk + window:].any()


@pytest.mark.parametrize("causal,window", [(True, None), (True, 3),
                                           (False, None), (True, 2)])
def test_flash_attention_function_gradcheck(causal, window):
    """``ops.flash_attention`` as an autograd Function (the plain forward
    and ``attention_bwd_ref`` on the CPU) in float64, GQA 2:1, Tq > Tk."""
    torch.manual_seed(0)
    q = torch.randn(2, 4, 9, 8, dtype=torch.float64, requires_grad=True)
    k = torch.randn(2, 2, 7, 8, dtype=torch.float64, requires_grad=True)
    v = torch.randn(2, 2, 7, 8, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: fa_ops.flash_attention(
            q_, k_, v_, causal=causal, window=window), (q, k, v))


def test_rmsnorm_function_gradcheck():
    torch.manual_seed(1)
    x = torch.randn(5, 3, 8, dtype=torch.float64, requires_grad=True)
    s = torch.randn(8, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda x_, s_: rn_ops.rmsnorm(x_, s_),
                                    (x, s))


def test_functions_leave_no_grad_calls_as_they_were():
    """Under ``no_grad`` (serving) the wrappers are the plain calls."""
    torch.manual_seed(2)
    q = torch.randn(1, 2, 5, 8, requires_grad=True)
    with torch.no_grad():
        out = fa_ops.flash_attention(q, q, q)
        y = rn_ops.rmsnorm(q, torch.zeros(8, requires_grad=True))
    assert out.grad_fn is None and y.grad_fn is None
    assert fa_ops.flash_attention(q, q, q).grad_fn is not None
    assert torch.equal(out, fa_ops.flash_attention(q, q, q).detach())


# --- cross-entropy ----------------------------------------------------------

def _ce_inputs():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 13, 16)).astype(np.float32)
    head = rng.normal(0, 0.5, (16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 13)).astype(np.int32)
    labels[0, 3] = labels[1, 7] = -1
    return x, head, labels


@pytest.mark.parametrize("chunk", [0, 4, 13])
@pytest.mark.parametrize("z_weight", [0.0, 1e-2])
def test_cross_entropy_values_and_grads_match_jax(chunk, z_weight):
    """Plain CE (chunk 0) and chunked CE (a ragged last chunk at 4): loss,
    token count and the gradients with respect to x and the head."""
    x, head, labels = _ce_inputs()
    jl = jnp.asarray(labels)

    def jloss(x_, h_):
        if chunk:
            return JT.chunked_cross_entropy(x_, h_, jl, chunk, z_weight)
        return JT.cross_entropy(x_ @ h_, jl, z_weight)

    (jv, jn), vjp = jax.vjp(jloss, jnp.asarray(x), jnp.asarray(head))
    jdx, jdh = vjp((jnp.float32(1.0), jnp.float32(0.0)))
    tx, th = _t(x).requires_grad_(), _t(head).requires_grad_()
    tl = torch.from_numpy(labels)
    if chunk:
        tv, tn = TT.chunked_cross_entropy(tx, th, tl, chunk, z_weight)
    else:
        tv, tn = TT.cross_entropy(tx @ th, tl, z_weight)
    tv.backward()
    assert float(tn) == float(jn) == 24.0
    assert float(tv.detach()) == pytest.approx(float(jv), rel=1e-6)
    close(tx.grad, jdx)
    close(th.grad, jdh)


# --- train_step against the JAX package ---------------------------------------

def _batch(vocab, seed=0, b=4, s=32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[rng.random((b, s)) < 0.1] = -1
    return toks, labels


@functools.lru_cache(maxsize=None)
def _trajectories(name):
    """Three steps of each package from the same parameters and batch;
    states and metrics after each step, as numpy."""
    jcfg, tcfg = jget_arch(name).smoke(), get_arch(name).smoke()
    jtc = JT.TrainConfig(optimizer=JAdamWConfig(
        lr=1e-3, weight_decay=0.1, schedule=jwarmup_cosine(1e-3, 2, 3)),
        remat=False)
    ttc = TT.TrainConfig(optimizer=AdamWConfig(
        lr=1e-3, weight_decay=0.1, schedule=warmup_cosine(1e-3, 2, 3)),
        remat=False)
    js = JT.init_state(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, js.params),
                                     tcfg, device="cpu")
    ts = TT.TrainState(params, adamw_init(params))
    toks, labels = _batch(tcfg.vocab)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jstep = jax.jit(lambda s, b: JT.train_step(jcfg, jtc, s, b))
    out = []
    for _ in range(3):
        js, jm = jstep(js, jb)
        ts, tm = TT.train_step(tcfg, ttc, ts, tb)
        out.append((
            {k: float(v) for k, v in jm.items()},
            {k: float(v) for k, v in tm.items()},
            [[np.asarray(x) for x in jax.tree.leaves(t)]
             for t in (js.params, js.opt.mu, js.opt.nu)],
            [[x.numpy() for x in tree_leaves(t)]
             for t in (ts.params, ts.opt.mu, ts.opt.nu)],
            int(js.opt.step), int(ts.opt.step),
            jax.tree.map(np.asarray, js.params)))
    return out


# mu and nu atol, x the leaf's max |want|, where a model needs its own
MOMENT_ATOL = {"zamba2-7b": 5e-5}


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", ["gemma3-1b", "granite-8b",
                                  "moonshot-v1-16b-a3b", "falcon-mamba-7b",
                                  "zamba2-7b"])
def test_train_step_matches_jax(name, steps):
    """zamba2-7b's mu and nu hold to 5e-5 x the leaf's max, not 1e-5: at
    steps 2 and 3 a few elements of some Mamba2 leaves (``pos5``'s, the
    layer before the shared block, among them) need 2.44e-5 / 1.86e-5 (mu
    / nu; 2.14e-5 / 1.00e-5 at step 3), while loss and grad norm agree to
    rel 1e-6.  Step 1's moments, taken at identical parameters, hold to
    1e-5, and the port's gradient at the JAX package's own step-2
    parameters holds to ``jax.grad`` within 6.5e-6 x each leaf's max
    (:func:`test_gradient_at_the_reference_step2_params_matches_jax`): the
    excess is AdamW carrying the step-1 parameters' last-bit differences
    into the next gradients, not a fault."""
    jm, tm, jtrees, ttrees, jstep, tstep, _ = _trajectories(name)[steps - 1]
    assert jstep == tstep == steps
    assert (jm["aux"] > 0) == name.startswith("moonshot")   # MoE aux loss
    for key in ("loss", "ce", "grad_norm", "n_tok", "aux"):
        assert tm[key] == pytest.approx(jm[key], rel=1e-5, abs=1e-7), key
    moment = MOMENT_ATOL.get(name, 1e-5)
    for what, jt, tt in zip(("params", "mu", "nu"), jtrees, ttrees):
        assert len(jt) == len(tt)
        for a, b in zip(tt, jt):
            atol = 1e-4 if what == "params" else moment * np.abs(b).max()
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol,
                                       err_msg=what)


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "zamba2-7b"])
def test_gradient_at_the_reference_step2_params_matches_jax(name):
    """The port's gradient (K5b's plain version for Mamba1, autograd of the
    plain SSD form for Mamba2) at the JAX package's parameters after its
    second step, against ``jax.grad`` there: every leaf within 1e-5 x its
    max |want| (worst measured 6.5e-6, zamba2)."""
    jcfg, tcfg = jget_arch(name).smoke(), get_arch(name).smoke()
    jparams = _trajectories(name)[1][6]
    toks, labels = _batch(tcfg.vocab)
    jtc = JT.TrainConfig(remat=False)
    want = jax.grad(lambda p: JT.loss_fn(jcfg, jtc, p, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})[0])(
        jax.tree.map(jnp.asarray, jparams))
    params = convert.params_from_jax(jparams, tcfg, device="cpu")
    _, _, got = TT.loss_and_grads(
        tcfg, TT.TrainConfig(remat=False), params,
        {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert float(np.abs(a.numpy() - b).max()) <= 1e-5 * np.abs(b).max()


def _port_state(name="granite-8b"):
    cfg = get_arch(name).smoke()
    state = TT.init_state(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    toks, _ = _batch(cfg.vocab, seed=1)
    toks = torch.from_numpy(toks)
    return cfg, state, {"tokens": toks, "labels": toks}


@pytest.mark.parametrize("name", ["granite-8b", "falcon-mamba-7b",
                                  "zamba2-7b"])
def test_microbatch_equivalence(name):
    """Gradient accumulation over 2 microbatches == the whole batch (as
    ``test_train_substrate.test_microbatch_equivalence``)."""
    cfg, state, batch = _port_state(name)
    s1, m1 = TT.train_step(cfg, TT.TrainConfig(remat=False), state, batch)
    s2, m2 = TT.train_step(cfg, TT.TrainConfig(remat=False, microbatches=2),
                           state, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-5)
    with pytest.raises(ValueError, match="multiple"):
        TT.train_step(cfg, TT.TrainConfig(microbatches=3), state, batch)


def test_gradients_are_freed_without_the_cycle_collector():
    """A step's gradients, and the trees the helpers rebuild, are freed as
    soon as the caller drops them, with Python's cyclic collector off.
    ``tree_like`` and the checkpoint's key walks used nested functions that
    called themselves: a reference cycle that held every leaf until a
    collection (22.2 GB of gradients on the card after a moonshot training
    check)."""
    from repro_torch.checkpoint import checkpoint as tck

    cfg = get_arch("gemma3-1b").smoke()
    state = TT.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 16)))
    batch = {"tokens": toks, "labels": toks}
    gc.collect()
    gc.disable()
    try:
        _, _, grads = TT.loss_and_grads(cfg, TT.TrainConfig(remat=False),
                                        state.params, batch)
        refs = [weakref.ref(g) for g in tree_leaves(grads)]
        del grads
        leaves = [torch.zeros(3) for _ in tree_leaves(state.params)]
        refs += [weakref.ref(x) for x in leaves]
        like = tree_like(state.params, leaves)
        flat = tck.flatten_with_keys(like)
        rebuilt = tck._rebuild(like, lambda key, leaf: leaf + 1)
        refs += [weakref.ref(x) for x in tree_leaves(rebuilt)]
        del leaves, like, flat, rebuilt
        assert sum(r() is not None for r in refs) == 0
    finally:
        gc.enable()


@pytest.mark.parametrize("name", ["granite-8b", "gemma3-1b",
                                  "moonshot-v1-16b-a3b", "falcon-mamba-7b",
                                  "zamba2-7b"])
def test_remat_equivalence(name):
    """Remat recomputes each block in the backward: the same loss and, on
    the CPU, the same gradients bit for bit."""
    cfg, state, batch = _port_state(name)
    s1, m1 = TT.train_step(cfg, TT.TrainConfig(remat=False), state, batch)
    s2, m2 = TT.train_step(cfg, TT.TrainConfig(remat=True), state, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    assert float(m1["grad_norm"]) == float(m2["grad_norm"])
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        assert torch.equal(a, b)


def test_chunked_ce_step_equals_plain_ce_step():
    cfg, state, batch = _port_state()
    _, m1 = TT.train_step(cfg, TT.TrainConfig(remat=False), state, batch)
    _, m2 = TT.train_step(cfg, TT.TrainConfig(remat=False, ce_chunk=8),
                          state, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]),
                                                   rel=1e-4)


def test_train_hidden_mode_returns_what_train_contracts():
    cfg, state, batch = _port_state("gemma3-1b")
    with torch.no_grad():
        logits, aux = TM.forward(cfg, state.params, batch["tokens"])
        x, head, aux2 = TM.forward(cfg, state.params, batch["tokens"],
                                   mode="train_hidden", remat=True)
    assert torch.equal(x @ head, logits) and float(aux) == float(aux2) == 0
    assert head.data_ptr() == state.params["embed"].data_ptr()  # tied
    with pytest.raises(ValueError, match="remat"):
        TM.forward(cfg, state.params, batch["tokens"], mode="prefill",
                   caches=TM.init_caches(cfg, 4, 32, device="cpu"),
                   remat=True)


def test_grad_transform_sees_the_gradients():
    cfg, state, batch = _port_state()
    seen = []

    def halve(grads):
        seen.append(grads)
        return tree_like(grads, [g * 0.5 for g in tree_leaves(grads)])

    tc = TT.TrainConfig(remat=False, optimizer=AdamWConfig(clip_norm=None))
    _, m1 = TT.train_step(cfg, tc, state, batch)
    _, m2 = TT.train_step(cfg, tc, state, batch, grad_transform=halve)
    assert len(seen) == 1 and set(seen[0]) == set(state.params)
    assert float(m2["grad_norm"]) == pytest.approx(
        0.5 * float(m1["grad_norm"]), rel=1e-6)


def test_loss_decreases_end_to_end():
    cfg = get_arch("gemma3-1b").smoke()
    tc = TT.TrainConfig(optimizer=AdamWConfig(lr=3e-3), remat=False)
    state = TT.init_state(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=8))
    losses = []
    for i in range(6):
        b = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
        state, m = TT.train_step(cfg, tc, state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


# --- data pipeline ------------------------------------------------------------

@pytest.mark.parametrize("seed,index,n_hosts", [(0, 0, 1), (7, 3, 1),
                                                (1, 2, 2), (5, 11, 4)])
def test_data_batches_bitwise_equal_the_reference(seed, index, n_hosts):
    for host in range(n_hosts):
        kw = dict(vocab=300, seq_len=48, global_batch=8, seed=seed,
                  mean_doc_len=20.0, n_hosts=n_hosts, host_id=host)
        got = SyntheticLM(DataConfig(**kw)).batch(index)
        want = JSyntheticLM(JDataConfig(**kw)).batch(index)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# --- CLI --------------------------------------------------------------------

def _train(*extra, env_extra=None):
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin"),
           **(env_extra or {})}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-8b", "--smoke", "--batch", "4", "--seq", "32", *extra],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)


def test_train_cli_on_cpu_prints_its_lines_and_resumes(tmp_path):
    out = _train("--steps", "5", "--device", "cpu", "--ckpt-dir",
                 str(tmp_path), "--ckpt-every", "3", "--log-every", "1")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("[train] arch=granite-8b-smoke layers=2")
    assert sum(line.startswith("step ") for line in lines) == 5
    assert any(line.startswith("[ckpt] final checkpoint at") and
               line.endswith("step_00000005") for line in lines)
    assert lines[-1].startswith("[done] 5 steps")
    out2 = _train("--steps", "7", "--device", "cpu", "--ckpt-dir",
                  str(tmp_path), "--resume", "--log-every", "1")
    assert out2.returncode == 0, out2.stderr[-2000:]
    assert "[ckpt] resumed from step 5" in out2.stdout
    assert [l.split()[1] for l in out2.stdout.splitlines()
            if l.startswith("step ")] == ["5", "6"]


def test_train_cli_without_a_card_raises_the_device_error():
    out = _train("--steps", "1", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr, out.stderr[-2000:]
    assert "device='cpu'" in out.stderr


def test_train_cli_refuses_the_production_mesh():
    """``--mesh single`` in one process (no world of 256 ranks) raises,
    naming both sizes."""
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="256 ranks.*has 1"):
        train.main(["--mesh", "single", "--device", "cpu"])


def test_train_cli_trains_over_a_mesh_on_four_ranks():
    """``--mesh single`` on 4 gloo ranks with the production mesh patched
    to (data 2, model 2) inside each rank: rank 0 prints the reference's
    lines (``[train]``, ``[mesh] DGRO order``, ``step ...``, ``[done]``),
    the others nothing, and every rank's losses equal a direct
    ``train_step`` loop's over the same mesh."""
    from repro_torch import distributed as D
    from test_torch_tensor_parallel import launcher_rank

    ranks = D.spawn_ranks(launcher_rank, 4, timeout=180)
    lines = ranks[0][0].splitlines()
    assert lines[0].startswith("[train] arch=gemma3-1b-smoke")
    assert lines[1].startswith("[mesh] DGRO order: {'rho'")
    assert sum(line.startswith("step ") for line in lines) == 3
    assert lines[-1].startswith("[done] 3 steps")
    assert all(out == "" for out, _, _ in ranks[1:])
    for _, losses, direct in ranks:
        assert losses == direct == ranks[0][1]
        assert np.all(np.isfinite(losses))


def test_train_cli_takes_a_mesh_shape_as_the_serve_cli_does():
    """``--mesh single --mesh-shape 2,2`` on 4 gloo ranks, without a
    patch (``launch.mesh.mesh_from_flags``, shared with ``launch.serve``):
    the losses are the one-device launcher's (rel 1e-5) on every rank, and
    only rank 0 prints."""
    from repro_torch import distributed as D
    from repro_torch.launch import train
    from test_torch_tensor_parallel import LAUNCH, shape_launcher_rank

    ranks = D.spawn_ranks(shape_launcher_rank, 4, timeout=180)
    want = train.main([a for a in LAUNCH if a not in ("--mesh", "single")])
    assert ranks[0][0].splitlines()[0].startswith("[train] arch=")
    assert all(out == "" for out, _ in ranks[1:])
    for _, losses in ranks:
        assert losses == ranks[0][1]
        assert losses == pytest.approx(want, rel=1e-5)


def test_train_cli_over_a_mesh_takes_the_global_microbatches():
    """``--mesh single --microbatches 2`` on 4 gloo ranks (mesh patched to
    (data 2, model 2)): each rank holds its part of both microbatches of
    the global batch, so the losses are the one-device launcher's with 2
    microbatches (rel 1e-5) and a direct loop's."""
    from repro_torch import distributed as D
    from repro_torch.launch import train
    from test_torch_tensor_parallel import LAUNCH, launcher_rank

    ranks = D.spawn_ranks(launcher_rank, 4, args=(2,), timeout=180)
    one = [a for a in LAUNCH if a not in ("--mesh", "single")]
    want = train.main(one + ["--microbatches", "2"])
    for _, losses, direct in ranks:
        assert losses == direct == ranks[0][1]
        assert losses == pytest.approx(want, rel=1e-5)
