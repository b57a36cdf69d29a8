"""The port's Mamba and hybrid families against the JAX package, on the CPU.

The same numpy inputs and the JAX package's own parameters (carried across
by ``convert.params_from_jax``) go through both.  JAX runs as its own
tests run it (``tests/test_models.py``): the plain jnp model on the CPU.
The configs are falcon-mamba-7b smoke (2 Mamba1 layers) and zamba2-7b
smoke (12 Mamba2 layers, the shared attention + MLP block after the 6th
and the 12th).  On the CPU the scan wrapper takes its plain version; K5
itself is held to it on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  Training them is held to the reference by
``tests/test_torch_train.py`` and ``tests/test_torch_ssm_train.py``.

Tolerances, with their reasons:
  * Scan and layer pieces: rtol = atol = 1e-5 (fp32 steps run in order
    here, by ``lax.associative_scan`` there; products summed in another
    order); the conv state is a copy of inputs, compared the same way.
  * Whole models: the LM tests' rtol = atol = 1e-4.
  * Greedy tokens: identical.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.models import mamba as JMa
from repro.models import model as JM

from repro_torch.configs import get_arch
from repro_torch.kernels.selective_scan import ops as ss_ops
from repro_torch.kernels.selective_scan.ref import (selective_scan_gated_ref,
                                                    selective_scan_ref)
from repro_torch.launch.serve import generate
from repro_torch.models import convert
from repro_torch.models import mamba as TMa
from repro_torch.models import model as TM
from test_torch_lm import _jax_serve_loop

RTOL = ATOL = 1e-4
PIECE = 1e-5
ROOT = os.path.join(os.path.dirname(__file__), "..")
FALCON = "falcon-mamba-7b"
ZAMBA = "zamba2-7b"


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=PIECE):
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=tol,
                               atol=tol)


def _cfgs(name):
    return jget_arch(name).smoke(), get_arch(name).smoke()


# --- the pieces -------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_and_conv_step_match_jax(with_state):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 9, 12)).astype(np.float32)
    w = rng.normal(0, 1, (4, 12)).astype(np.float32)
    b = rng.normal(0, 1, (12,)).astype(np.float32)
    st = rng.normal(0, 1, (2, 3, 12)).astype(np.float32) if with_state \
        else None
    jy, jst = JMa._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               None if st is None else jnp.asarray(st))
    ty, tst = TMa._causal_conv(_t(x), _t(w), _t(b),
                               None if st is None else _t(st))
    _close(ty, jy)
    _close(tst, jst)
    x1 = rng.normal(0, 1, (2, 12)).astype(np.float32)
    jy1, jst1 = JMa._conv_step(jnp.asarray(x1), jnp.asarray(w),
                               jnp.asarray(b), jst)
    ty1, tst1 = TMa._conv_step(_t(x1), _t(w), _t(b), tst)
    _close(ty1, jy1)
    _close(tst1, jst1)


def _scan_inputs(b, s, d, n, seed):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(-2.0, 1.0, (b, s, d)))).astype(np.float32)
    a = -np.broadcast_to(np.arange(1, n + 1, dtype=np.float32), (d, n))
    return (dt, rng.normal(0, 1, (b, s, d)), rng.normal(0, 1, (b, s, n)),
            rng.normal(0, 1, (b, s, n)), np.array(a),
            rng.normal(0, 1, (b, d, n)))


@pytest.mark.parametrize("s", [24, 256])
def test_plain_scan_matches_jax(s):
    """S = 24 (one chunk) and S = 256 (two chunks: the carried state), a
    nonzero h0; the public wrapper takes the plain version on the CPU."""
    ins = _scan_inputs(3, s, 20, 8, seed=s)
    jy, jh = JMa._ssm_scan_chunked(*(jnp.asarray(a, jnp.float32)
                                     for a in ins), chunk=min(128, s))
    ty, th = selective_scan_ref(*(_t(a) for a in ins))
    _close(ty, jy)
    _close(th, jh)
    oy, oh = ss_ops.selective_scan(*(_t(a) for a in ins))
    assert torch.equal(oy, ty) and torch.equal(oh, th)


@pytest.mark.parametrize("s", [24, 256])
def test_gated_plain_scan_matches_jax(s):
    """K5's gated twin against ``_ssm_scan_chunked`` followed by the
    reference's two lines in jnp (``y + D x``, then ``* silu(z)``), at the
    sizes of ``test_plain_scan_matches_jax``; the public wrapper given D
    and z takes the same twin on the CPU."""
    ins = _scan_inputs(3, s, 20, 8, seed=s)
    rng = np.random.default_rng(s + 1)
    dskip = rng.normal(0, 1, (20,)).astype(np.float32)
    z = rng.normal(0, 1, (3, s, 20)).astype(np.float32)
    jins = tuple(jnp.asarray(a, jnp.float32) for a in ins)
    jy, jh = JMa._ssm_scan_chunked(*jins, chunk=min(128, s))
    jy = jy + jnp.asarray(dskip) * jins[1]
    jy = jy * jax.nn.silu(jnp.asarray(z))
    tins = tuple(_t(a) for a in ins)
    ty, th = selective_scan_gated_ref(*tins, _t(dskip), _t(z))
    _close(ty, jy)
    _close(th, jh)
    oy, oh = ss_ops.selective_scan(*tins, _t(dskip), _t(z))
    assert torch.equal(oy, ty) and torch.equal(oh, th)


def test_scan_wrapper_refuses_a_bad_gate():
    """D and z come together, at (d,) and (B, S, d), on every device."""
    tins = tuple(_t(a) for a in _scan_inputs(2, 8, 12, 4, seed=3))
    dskip, z = torch.ones(12), torch.ones(2, 8, 12)
    with pytest.raises(ValueError, match="both D and z"):
        ss_ops.selective_scan(*tins, dskip, None)
    with pytest.raises(ValueError, match="both D and z"):
        ss_ops.selective_scan(*tins, None, z)
    with pytest.raises(ValueError, match="'D'"):
        ss_ops.selective_scan(*tins, torch.ones(13), z)
    with pytest.raises(ValueError, match="'z'"):
        ss_ops.selective_scan(*tins, dskip, torch.ones(2, 8, 13))


def _block(name, seed=0):
    """One layer's weights of the smoke config, the JAX init carried."""
    jcfg, tcfg = _cfgs(name)
    init = JMa.init_mamba1 if jcfg.ssm_kind == "mamba1" else JMa.init_mamba2
    jp = init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, tcfg, jp, {k: _t(np.asarray(v)) for k, v in jp.items()}


@pytest.mark.parametrize("name", [FALCON, ZAMBA])
def test_mamba_apply_and_step_match_jax(name):
    """``*_apply`` over 23 tokens from a nonzero state, then ``*_step`` on
    the 24th, in both packages; and each package's step against its own
    apply over all 24 tokens."""
    jcfg, tcfg, jp, tp = _block(name)
    jfam = "mamba1" if jcfg.ssm_kind == "mamba1" else "mamba2"
    japply, jstep = getattr(JMa, jfam + "_apply"), getattr(JMa, jfam + "_step")
    tapply, tstep = getattr(TMa, jfam + "_apply"), getattr(TMa, jfam + "_step")
    jshape = getattr(JMa, jfam + "_state_shape")(jcfg, 2)
    assert getattr(TMa, jfam + "_state_shape")(tcfg, 2) == jshape
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 24, jcfg.d_model)).astype(np.float32)
    st = tuple(rng.normal(0, 0.5, s).astype(np.float32) for s in jshape)
    jy, jst = japply(jp, jnp.asarray(x[:, :23]), jcfg,
                     tuple(jnp.asarray(a) for a in st))
    ty, tst = tapply(tp, _t(x[:, :23]), tcfg, tuple(_t(a) for a in st))
    _close(ty, jy)
    for g, w in zip(tst, jst):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    jy1, jst1 = jstep(jp, jnp.asarray(x[:, 23]), jcfg, jst)
    ty1, tst1 = tstep(tp, _t(x[:, 23]), tcfg, tst)
    _close(ty1, jy1)
    for g, w in zip(tst1, jst1):
        _close(g, w)
    # step against apply, in each package
    jall, jst_all = japply(jp, jnp.asarray(x), jcfg,
                           tuple(jnp.asarray(a) for a in st))
    tall, tst_all = tapply(tp, _t(x), tcfg, tuple(_t(a) for a in st))
    np.testing.assert_allclose(_np(jy1), _np(jall[:, -1]), rtol=PIECE,
                               atol=PIECE)
    _close(ty1, jall[:, -1])
    np.testing.assert_allclose(ty1.numpy(), tall[:, -1].numpy(), rtol=PIECE,
                               atol=PIECE)
    for g, w in zip(tst1, tst_all):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=PIECE,
                                   atol=PIECE)


def test_mamba1_apply_and_step_call_the_gated_scan(monkeypatch):
    """Sequence mode and the decode step both hand the scan and its gate to
    the one scan wrapper (K5 on CUDA), the step at S = 1 from the cached
    state; no torch code of the gate or the recurrence is left beside it."""
    jcfg, tcfg, jp, tp = _block(FALCON)
    calls = []

    def spy(dt, x, bmat, cmat, a, h0, dskip=None, z=None):
        calls.append((tuple(dt.shape), h0, dskip, None if z is None
                      else tuple(z.shape)))
        return ss_ops.selective_scan(dt, x, bmat, cmat, a, h0, dskip, z)

    monkeypatch.setattr(TMa, "selective_scan", spy)
    x = _t(np.random.default_rng(4).normal(0, 1, (2, 8, tcfg.d_model)))
    _, st = TMa.mamba1_apply(tp, x, tcfg)
    TMa.mamba1_step(tp, x[:, -1], tcfg, st)
    di = tcfg.d_inner
    assert [(c[0], c[3]) for c in calls] == [((2, 8, di), (2, 8, di)),
                                             ((2, 1, di), (2, 1, di))]
    assert calls[1][1] is st[1]
    assert all(c[2] is tp["D"] for c in calls)


@pytest.mark.parametrize("name", [FALCON, ZAMBA])
def test_sequence_not_a_multiple_of_the_chunk_is_refused(name):
    """The reference asserts ``s % chunk == 0`` once s > 128 (a prompt of
    130); the port raises.  s <= 128 is one chunk in both."""
    jcfg, tcfg, jp, tp = _block(name)
    x = np.zeros((1, 130, jcfg.d_model), np.float32)
    japply = JMa.mamba1_apply if jcfg.ssm_kind == "mamba1" \
        else JMa.mamba2_apply
    tapply = TMa.mamba1_apply if jcfg.ssm_kind == "mamba1" \
        else TMa.mamba2_apply
    with pytest.raises(AssertionError):
        japply(jp, jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="not a multiple"):
        tapply(tp, _t(x), tcfg)
    assert tapply(tp, _t(x[:, :100]), tcfg)[0].shape == (1, 100,
                                                         jcfg.d_model)


def test_mamba2_gradient_stays_finite_past_the_decay_range():
    """dt ~ 3 (dt_b = 3, as training at a high learning rate reaches) puts
    a 32-step chunk's log-decays ~97 apart, past fp32's exp range (~88).
    The reference's output stays finite but its ``jax.grad`` is NaN in the
    dt leaves: it masks ``exp(ldiff)`` after taking it, and the masked
    branch's gradient is 0 * inf.  The port masks before the exp: its
    output holds to the reference's, and its gradient is finite and holds
    to that of the step-by-step recurrence (``mamba2_step`` over the 32
    tokens, no quadratic form) within 1e-4 x each leaf's max |g| (the
    worst measured, A_log, 2e-5)."""
    jcfg, tcfg, jp, tp = _block(ZAMBA)
    jp = dict(jp, dt_b=jnp.full_like(jp["dt_b"], 3.0))
    tp = dict(tp, dt_b=torch.full_like(tp["dt_b"], 3.0))
    x = np.random.default_rng(1).normal(0, 1, (2, 32, jcfg.d_model)) \
        .astype(np.float32)
    jy = JMa.mamba2_apply(jp, jnp.asarray(x), jcfg)[0]
    jg = jax.grad(lambda p: jnp.sum(
        JMa.mamba2_apply(p, jnp.asarray(x), jcfg)[0] ** 2))(jp)
    assert bool(jnp.isfinite(jy).all())
    assert not bool(jnp.isfinite(jg["dt_b"]).all())
    seq = {k: v.clone().requires_grad_() for k, v in tp.items()}
    y = TMa.mamba2_apply(seq, _t(x), tcfg)[0]
    _close(y.detach(), jy)
    y.square().sum().backward()
    step = {k: v.clone().requires_grad_() for k, v in tp.items()}
    st = tuple(torch.zeros(sh) for sh in TMa.mamba2_state_shape(tcfg, 2))
    ys = []
    for t in range(32):
        y1, st = TMa.mamba2_step(step, _t(x[:, t]), tcfg, st)
        ys.append(y1)
    torch.stack(ys, 1).square().sum().backward()
    for k, p in seq.items():
        assert bool(torch.isfinite(p.grad).all()), k
        want = step[k].grad
        assert float((p.grad - want).abs().max()) \
            <= 1e-4 * float(want.abs().max()), k


# --- whole models ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _carried(name):
    jcfg, tcfg = _cfgs(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, convert.params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_modes(name):
    """The reference's train, train_hidden, prefill and three decode steps
    on one batch (shared by the tests that compare with them)."""
    jcfg, _, jp, _ = _carried(name)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jcfg.vocab, size=(2, 24))
    nxt = rng.integers(1, jcfg.vocab, size=(3, 2, 1))
    out = {"toks": toks, "nxt": nxt}
    out["train"], _ = JM.forward(jcfg, jp, jnp.asarray(toks), mode="train")
    out["hidden"], out["head"], _ = JM.forward(jcfg, jp, jnp.asarray(toks),
                                               mode="train_hidden")
    jc = JM.init_caches(jcfg, 2, 40)
    out["prefill"], jc, _ = JM.forward(jcfg, jp, jnp.asarray(toks),
                                       mode="prefill", caches=jc)
    out["decode"] = []
    for i in range(3):
        lg, jc = JM.forward(jcfg, jp, jnp.asarray(nxt[i]), mode="decode",
                            caches=jc, pos=jnp.int32(24 + i))
        out["decode"].append(lg)
    out["caches"] = convert.flatten(jax.tree.map(np.asarray, jc))
    return out


@pytest.mark.parametrize("name", [FALCON, ZAMBA])
def test_forward_all_modes_match_jax(name):
    """train, train_hidden (with remat), prefill and three decode steps,
    and every cache entry after them (conv and SSM states, the shared
    block's K/V)."""
    jcfg, tcfg, _, tp = _carried(name)
    want = _jax_modes(name)
    assert TM.pattern_period(tcfg) == JM.pattern_period(jcfg)
    assert [TM.layer_kind(tcfg, j) for j in range(TM.pattern_period(tcfg))] \
        == [{"shared_attn": False, **JM.layer_kind(jcfg, j)}
            for j in range(JM.pattern_period(jcfg))]
    toks = torch.from_numpy(want["toks"])
    got, aux = TM.forward(tcfg, tp, toks, mode="train")
    np.testing.assert_allclose(got.numpy(), _np(want["train"]), rtol=RTOL,
                               atol=ATOL)
    assert float(aux) == 0.0
    x, head, _ = TM.forward(tcfg, tp, toks, mode="train_hidden", remat=True)
    np.testing.assert_allclose(x.numpy(), _np(want["hidden"]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(head.numpy(), _np(want["head"]))

    tc = TM.init_caches(tcfg, 2, 40, device="cpu")
    got, tc2, _ = TM.forward(tcfg, tp, toks, mode="prefill", caches=tc)
    assert tc2 is tc                          # written in place
    np.testing.assert_allclose(got.numpy(), _np(want["prefill"]), rtol=RTOL,
                               atol=ATOL)
    for i in range(3):
        got, tc = TM.forward(tcfg, tp, torch.from_numpy(want["nxt"][i]),
                             mode="decode", caches=tc, pos=24 + i)
        np.testing.assert_allclose(got.numpy(), _np(want["decode"][i]),
                                   rtol=RTOL, atol=ATOL)
    tflat = convert.flatten(tc)
    assert sorted(tflat) == sorted(want["caches"])
    for key, val in tflat.items():
        np.testing.assert_allclose(val.numpy(), want["caches"][key],
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    if name == ZAMBA:
        assert "blocks/pos5/k" in tflat and "blocks/pos4/k" not in tflat


@pytest.mark.parametrize("name", [FALCON, ZAMBA])
def test_forward_impls_agree_on_cpu(name):
    _, tcfg, _, tp = _carried(name)
    toks = torch.from_numpy(_jax_modes(name)["toks"])
    a, _ = TM.forward(tcfg, tp, toks, impl="flash")
    b, _ = TM.forward(tcfg, tp, toks, impl="ref")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", [FALCON, ZAMBA])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_caches_shapes_and_dtypes_match_jax(name, dtype):
    jcfg, tcfg = _cfgs(name)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = convert.flatten(jax.eval_shape(
        lambda: JM.init_caches(jcfg, 3, 48, dtype=jdt)))
    got = convert.flatten(TM.init_caches(tcfg, 3, 48, dtype=dtype,
                                         device="cpu"))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert {k: str(v.dtype)[6:] for k, v in got.items()} == \
        {k: str(v.dtype) for k, v in want.items()}
    assert all(not v.any() for v in got.values())


@pytest.mark.parametrize("name", [FALCON, ZAMBA])
def test_generate_greedy_tokens_match_jax_serve_loop(name):
    jcfg, tcfg, jp, tp = _carried(name)
    prompts = np.random.default_rng(1).integers(1, jcfg.vocab, size=(3, 20))
    want = _jax_serve_loop(jcfg, jp, prompts, max_new=8, max_len=32)
    got, _ = generate(tcfg, tp, prompts, max_new=8, max_len=32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,count", [(FALCON, 7_272_665_088),
                                        (ZAMBA, 6_751_130_832)])
def test_full_width_layout_matches_jax(name, count):
    """The full-width trees on the ``meta`` device against
    ``jax.eval_shape``, names, shapes and dtypes: no memory is
    allocated."""
    want = jax.eval_shape(lambda k: JM.init_params(jget_arch(name), k),
                          jax.random.PRNGKey(0))
    dtypes = {n: str(s.dtype) for n, s in convert.flatten(want).items()}
    want = {n: tuple(s.shape) for n, s in convert.flatten(want).items()}
    assert convert.param_shapes(get_arch(name)) == want
    meta = TM.init_params(get_arch(name), device="meta")
    assert {n: str(t.dtype)[6:] for n, t in
            convert.flatten(meta).items()} == dtypes
    assert TM.param_count(meta) == count == sum(
        int(np.prod(s)) for s in want.values())
    if name == ZAMBA:
        assert want["shared_attn/attn/wq"] == (3584, 32 * 112)
        assert want["blocks/pos0/mamba/A_log"] == (13, 112)
        assert "rem/rem2/mamba/out_proj" in want
    else:
        assert want["blocks/pos0/mamba/A_log"] == (64, 8192, 16)


@pytest.mark.parametrize("name", [FALCON, ZAMBA])
def test_params_from_jax_keeps_the_ssm_fp32_leaves(name):
    jcfg, tcfg = _cfgs(name)
    jp = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    got = convert.flatten(convert.params_from_jax(jp, tcfg, device="cpu",
                                                  dtype=torch.bfloat16))
    jflat = convert.flatten(jp)
    fp32 = {"mamba/A_log", "mamba/D"} | (
        {"mamba/dt_b"} if jcfg.ssm_kind == "mamba2" else set())
    for key, t in got.items():
        want = torch.float32 if any(key.endswith(f) for f in fp32) \
            else torch.bfloat16
        assert t.dtype == want, key
        assert str(jflat[key].dtype) == str(t.dtype)[6:], key
    np.testing.assert_array_equal(got["blocks/pos0/mamba/A_log"].numpy(),
                                  jflat["blocks/pos0/mamba/A_log"])


# --- CLIs --------------------------------------------------------------------

def _cli(module, name, *args):
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin")}
    return subprocess.run(
        [sys.executable, "-m", module, "--arch", name, "--smoke",
         "--device", "cpu", *args],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)


@pytest.mark.parametrize("name", [FALCON, ZAMBA])
def test_serve_cli_runs_ssm_smoke_on_cpu(name):
    out = _cli("repro_torch.launch.serve", name, "--requests", "2",
               "--prompt-len", "20", "--max-new", "4")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("[serve]") == 3, out.stdout
    assert f"arch={name}-smoke" in out.stdout

