"""Training the port's SSM families against the JAX package, on the CPU.

The selective scan's plain backward (``selective_scan_bwd_ref``, the twin
of K5b) against ``jax.vjp`` of the reference's ``_ssm_scan_chunked`` and
the gate lines after it (``src/repro/models/mamba.py:142-145``); the scan
as an autograd Function on the CPU against torch autograd of its plain
forward; falcon-mamba-7b and zamba2-7b training states across the two
packages' checkpoints; and the train CLI on both.  ``train_step`` itself
is held to the reference in ``tests/test_torch_train.py``; K5b to its
plain version on the card in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  Two properties K5b's design rests on are held here:
its tile and channel constants as the CUDA sources define them, and a
plain backward that zero steps leave unchanged.

Tolerances: |diff| <= 1e-5 x max(1, max |want|) (fp32 steps in order
here, a ``lax.associative_scan`` there; sums over channels, steps and
states in another order).
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import checkpoint as jck
from repro.models import mamba as JMa

from repro_torch.checkpoint import checkpoint as tck
from repro_torch.kernels.selective_scan import kernel as ss_kernel
from repro_torch.kernels.selective_scan import ops as ss_ops
from repro_torch.kernels.selective_scan.ref import (selective_scan_bwd_ref,
                                                    selective_scan_gated_ref,
                                                    selective_scan_ref)
from test_torch_checkpoint import _jleaves, _states, _tleaves

ROOT = os.path.join(os.path.dirname(__file__), "..")
NAMES = ["falcon-mamba-7b", "zamba2-7b"]


def close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    top = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * top, (err, tol * top)


def _inputs(shape, seed):
    """The scan's inputs as numpy: dt = softplus(N(-4.6, 1)) (dt ~ 0.01,
    the layers' dt_b), x, B, C, a nonzero h0 and the gate's D and z unit
    normals, A = -(1..N) per channel; random cotangents of y and h_last."""
    b, s, d, n = shape
    rng = np.random.default_rng(seed)

    def normal(*sh):
        return rng.normal(0, 1, sh).astype(np.float32)

    dt = np.log1p(np.exp(rng.normal(-4.6, 1, (b, s, d)))).astype(np.float32)
    a = -np.broadcast_to(np.arange(1, n + 1, dtype=np.float32), (d, n))
    ins = (dt, normal(b, s, d), normal(b, s, n), normal(b, s, n),
           np.ascontiguousarray(a), normal(b, d, n))
    return ins, (normal(d), normal(b, s, d)), (normal(b, s, d),
                                               normal(b, d, n))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("shape", [(2, 32, 16, 8), (2, 256, 16, 16)])
def test_selective_scan_bwd_ref_matches_jax_vjp(shape, gated):
    """Every gradient of the plain backward against ``jax.vjp`` of the
    reference's chunked scan (one chunk of 32; two of 128), then, gated,
    ``y + D x`` and ``* silu(z)`` as ``mamba1_apply`` writes them: nonzero
    h0, random cotangents on both y and h_last."""
    ins, gate, (dout, dh_last) = _inputs(shape, seed=sum(shape) + gated)
    chunk = min(128, shape[1])

    def jfwd(dt, x, bm, cm, a, h0, *g):
        y, h = JMa._ssm_scan_chunked(dt, x, bm, cm, a, h0, chunk)
        if g:
            y = (y + g[0] * x) * jax.nn.silu(g[1])
        return y, h

    args = ins + (gate if gated else ())
    _, vjp = jax.vjp(jfwd, *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dout), jnp.asarray(dh_last)))
    got = selective_scan_bwd_ref(*(_t(a) for a in ins), _t(dout),
                                 _t(dh_last), *(_t(a) for a in gate)
                                 if gated else ())
    assert len(got) == len(want) == (8 if gated else 6)
    for g, w in zip(got, want):
        close(g, w)


def test_scan_kernel_constants_match_the_cuda_sources():
    """``kernel.STATE_EVERY`` is K5's tile of saved states and K5b's TILE,
    and ``kernel.BWD_CH`` K5b's channels a block (``K5B_CH``), as the two
    ``.cu`` sources define them: the wrapper sizes ``hs`` and the dB / dC
    partials by them, and a mismatch would have the card write the
    partials out of bounds."""
    csrc = ss_kernel.FAMILY.csrc
    fwd = (csrc / ss_kernel.SOURCES["selective_scan"]).read_text()
    bwd = (csrc / ss_kernel.SOURCES["selective_scan_bwd"]).read_text()

    def const(text, name):
        got = re.findall(rf"(?:constexpr int {name} =|#define {name}) "
                         rf"(\d+)", text)
        assert len(got) == 1, (name, got)
        return int(got[0])

    assert ss_kernel.STATE_EVERY == const(fwd, "STATE_EVERY") \
        == const(fwd, "K5_TILE") == const(bwd, "TILE") == 16
    assert ss_kernel.BWD_CH == const(bwd, "K5B_CH")


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("shape,pad", [((2, 21, 12, 5), 11),
                                       ((3, 17, 40, 16), 15),
                                       ((2, 1, 8, 1), 15)])
def test_selective_scan_bwd_ref_ignores_zero_steps(shape, pad, gated):
    """K5b stages a ragged last tile as zero steps (dt = x = dout = z = 0,
    B = C = 0) and runs it whole.  The plain backward on a sequence padded
    so gives the real steps' ddt, dx, dB, dC (and dz), and dA, dh0 (and
    dD), unchanged: a zero step's decay is exp(0) = 1 and every term it
    adds is 0.  In float64, so that torch's sums over a longer sequence
    (taken in another order) differ only by rounding, 1e-12 x max |want|;
    a step that added anything would show at ~1e-2."""
    ins, gate, (dout, dh_last) = _inputs(shape, seed=sum(shape) + gated)
    b, s = shape[:2]

    def t64(a):
        return torch.from_numpy(np.asarray(a, np.float64))

    def padded(a):
        a = t64(a)
        return torch.cat([a, a.new_zeros((b, pad) + a.shape[2:])], 1)

    real = [t64(a) for a in (*ins, dout, dh_last)] + \
        ([t64(a) for a in gate] if gated else [])
    seqs = [padded(a) for a in ins[:4]]
    more = [padded(dout), t64(dh_last)] + \
        ([t64(gate[0]), padded(gate[1])] if gated else [])
    want = selective_scan_bwd_ref(*real)
    got = selective_scan_bwd_ref(*seqs, t64(ins[4]), t64(ins[5]), *more)
    assert len(got) == len(want) == (8 if gated else 6)
    for g, w in zip(got, want):
        if g.dim() >= 3 and g.shape[1] == s + pad:   # (B, S, ...): real steps
            g = g[:, :s]
        assert g.shape == w.shape
        top = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-12 * top


@pytest.mark.parametrize("gated", [False, True])
def test_selective_scan_function_matches_autograd_of_plain(gated):
    """``ops.selective_scan`` under autograd on the CPU (the plain forward,
    then ``selective_scan_bwd_ref``) against torch autograd through the
    plain forward, as training calls it: h0 needs no gradient (None), h_last
    is not used (a None cotangent) and y's cotangent is not contiguous."""
    ins, gate, (dout, _) = _inputs((2, 40, 12, 5), seed=7 + gated)
    w = _t(dout).transpose(1, 2).contiguous()             # (B, d, S)
    grads = []
    for fwd in (ss_ops.selective_scan,
                selective_scan_gated_ref if gated else selective_scan_ref):
        leaves = [_t(a, grad=True) for a in ins[:5]] + [_t(ins[5])] + \
            ([_t(a, grad=True) for a in gate] if gated else [])
        y, _ = fwd(*leaves)
        loss = (y.transpose(1, 2) * w).sum()
        need = [t for t in leaves if t.requires_grad]
        grads.append(torch.autograd.grad(loss, need))
    assert len(grads[0]) == (7 if gated else 5)
    for g, want in zip(*grads):
        close(g, want)


def test_selective_scan_function_gradcheck():
    """The autograd Function in float64, gated and scan-only, every input
    and both outputs (``torch.autograd.gradcheck``)."""
    torch.manual_seed(0)
    b, s, d, n = 2, 19, 5, 3

    def leaf(*shape):
        return torch.randn(*shape, dtype=torch.float64, requires_grad=True)

    dt = torch.nn.functional.softplus(torch.randn(b, s, d, dtype=torch.float64)
                                      - 1).requires_grad_()
    a = (-torch.arange(1, n + 1, dtype=torch.float64).expand(d, n)
         .contiguous()).requires_grad_()
    args = (dt, leaf(b, s, d), leaf(b, s, n), leaf(b, s, n), a, leaf(b, d, n))
    assert torch.autograd.gradcheck(ss_ops.selective_scan, args)
    assert torch.autograd.gradcheck(ss_ops.selective_scan,
                                    args + (leaf(d), leaf(b, s, d)))


@pytest.mark.parametrize("name", NAMES)
def test_ssm_state_round_trips_across_packages(name, tmp_path):
    """A falcon-mamba-7b / zamba2-7b training state one step in, written by
    either package, restores into the other bitwise: the fp32 ``A_log``,
    ``D`` and ``dt_b`` leaves and their moments, and the 0-d step."""
    js, ts = _states(name)
    keys = list(tck.flatten_with_keys(ts))
    assert keys == list(jck._flatten(js)[0])
    fp32 = [k for k in keys if k.endswith(("['A_log']", "['D']",
                                            "['dt_b']"))]
    assert len(fp32) == 3 * 3 * (1 if name.startswith("falcon") else 6)
    jck.save(str(tmp_path / "j"), 1, js)
    got, step = tck.restore(str(tmp_path / "j"), ts)
    assert step == 1 and got.opt.step.shape == ()
    flat = tck.flatten_with_keys(got)
    assert all(flat[k].dtype == torch.float32 for k in fp32)
    for a, b in zip(_tleaves(got), _jleaves(js)):
        np.testing.assert_array_equal(a, b)
    tck.save(str(tmp_path / "t"), 2, got)
    back, step = jck.restore(str(tmp_path / "t"), js)
    assert step == 2
    for a, b in zip(_jleaves(back), _jleaves(js)):
        np.testing.assert_array_equal(a, b)


def _train(name, *args):
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", name,
         "--smoke", "--batch", "2", "--seq", "32", "--device", "cpu",
         "--log-every", "1", *args],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)


@pytest.mark.parametrize("name", NAMES)
def test_train_cli_trains_ssm_smoke_and_resumes(name, tmp_path):
    """``python -m repro_torch.launch.train --arch <ssm> --smoke --device
    cpu`` trains with the reference CLI's lines, checkpoints every step and
    resumes from the last."""
    out = _train(name, "--steps", "2", "--ckpt-dir", str(tmp_path),
                 "--ckpt-every", "1")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith(f"[train] arch={name}-smoke")
    assert sum(line.startswith("step ") for line in lines) == 2
    assert lines[-2].startswith("[ckpt] final checkpoint at")
    assert lines[-1].startswith("[done] 2 steps")
    loss = [float(line.split()[3]) for line in lines
            if line.startswith("step ")]
    assert all(np.isfinite(loss))
    out2 = _train(name, "--steps", "3", "--ckpt-dir", str(tmp_path),
                  "--resume")
    assert out2.returncode == 0, out2.stderr[-2000:]
    assert "[ckpt] resumed from step 2" in out2.stdout
    assert [l.split()[1] for l in out2.stdout.splitlines()
            if l.startswith("step ")] == ["2"]
