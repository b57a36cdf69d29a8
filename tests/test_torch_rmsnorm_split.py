"""K3 / K3b over a row split across ranks by columns (``ss`` / ``n``): a
rank holds a block of each row, and the ranks' partial sums of squares,
summed, give the whole row's mean square.  Mamba2's gated norm over a
model axis runs so (``models.mamba._gate_norm``).

On the CPU the blocks' outputs, normalised by the summed statistic, are
the whole row's within 1e-6 x max |want| (fp32; the sum of squares is
added in another order), and the gradient composed as the model composes
it (partial sums, summed, into K3's ``ss``; ``ops.rmsnorm``'s Function
returning the statistic's gradient) is the whole row's gradient within
1e-5 x max |want| (dx, dscale).  On the card (marker ``cuda``; skipped
here) the kernels' split form is held to its plain version at every
variant's shapes and at zamba2-7b's rank shapes, within 1e-6 (forward)
and 1e-5 (gradients) x max |want|.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rmsnorm import kernel as rn
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

EPS = 1e-6


def _inputs(rows, d, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed + rows + d)
    x = torch.from_numpy(rng.normal(0, 1.5, (rows, d)).astype(np.float32))
    s = torch.from_numpy(rng.normal(0, 0.3, (d,)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (rows, d)).astype(np.float32))
    return x.to(dtype), s.to(dtype), g.to(dtype)


def _close(got, want, tol):
    return float((got.float() - want.float()).abs().max()) \
        <= tol * float(want.float().abs().max())


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("rows,d", [(6, 64), (3, 96), (1, 256)])
def test_blocks_normalised_by_the_summed_statistic_are_the_whole_row(
        rows, d, parts):
    x, s, _ = _inputs(rows, d)
    want = rmsnorm_ref(x, s, EPS)
    w = d // parts
    ss = sum(x[:, i * w:(i + 1) * w].square().sum(-1) for i in range(parts))
    got = torch.cat([rn.rmsnorm_rows(x[:, i * w:(i + 1) * w],
                                     s[i * w:(i + 1) * w].contiguous(), EPS,
                                     ss, d) for i in range(parts)], dim=1)
    assert _close(got, want, 1e-6)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("shape", [(2, 3, 64), (5, 32)])
def test_split_gradient_composed_as_the_model_does_is_the_whole_rows(
        shape, parts):
    """``ss`` = the sum of the blocks' sums of squares, each block through
    ``ops.rmsnorm(..., ss, n)``; autograd of the sum of the outputs
    against a fixed cotangent gives the whole row's dx and dscale."""
    d = shape[-1]
    rows = int(np.prod(shape[:-1]))
    x0, s0, g0 = _inputs(rows, d, seed=1)
    x0, g0 = x0.reshape(shape), g0.reshape(shape)
    want_dx, want_ds = rmsnorm_bwd_ref(x0, s0, g0, EPS)
    x = x0.clone().requires_grad_(True)
    s = s0.clone().requires_grad_(True)
    w = d // parts
    blocks = [x[..., i * w:(i + 1) * w] for i in range(parts)]
    ss = sum(b.float().square().sum(-1) for b in blocks)
    out = torch.cat([rn_ops.rmsnorm(b, s[i * w:(i + 1) * w], EPS, ss, d)
                     for i, b in enumerate(blocks)], dim=-1)
    assert _close(out.detach(), rmsnorm_ref(x0, s0, EPS), 1e-6)
    (out * g0).sum().backward()
    assert _close(x.grad, want_dx, 1e-5)
    assert _close(s.grad, want_ds, 1e-5)


def test_split_form_refuses_a_bad_statistic():
    x, s, g = _inputs(4, 32)
    with pytest.raises(ValueError, match="ss must be"):
        rn.rmsnorm_rows(x, s, EPS, torch.ones(3), 64)
    with pytest.raises(ValueError, match="ss must be"):
        rn.rmsnorm_rows(x, s, EPS, torch.ones(4, dtype=torch.float64), 64)
    with pytest.raises(ValueError, match="n"):
        rn.rmsnorm_rows_bwd(x, s, g, EPS, torch.ones(4), 16)


def test_split_plain_gradient_holds_the_statistic():
    """The plain split gradient is the partial derivatives: dx with ss
    held (r g (1 + s)) and dss, checked against autograd of the plain
    forward with ss a leaf."""
    x, s, g = _inputs(5, 48, seed=2, dtype=torch.float64)
    ss = (x.square().sum(-1) * 2.5).requires_grad_(True)
    xl = x.clone().requires_grad_(True)
    sl = s.clone().requires_grad_(True)
    (rmsnorm_ref(xl, sl, EPS, ss, 120) * g).sum().backward()
    dx, ds, dss = rmsnorm_bwd_ref(x, s, g, EPS, ss.detach(), 120)
    assert torch.allclose(dx, xl.grad, rtol=1e-12, atol=0)
    assert torch.allclose(ds, sl.grad, rtol=1e-12, atol=0)
    assert torch.allclose(dss, ss.grad, rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# (rows, d, offset): "warp" (d <= 2048, many rows), "block" (few rows;
# wide rows), "loop" (past "block"'s reach), "scalar" (an unaligned row),
# and zamba2-7b's gate norm a rank at a 4-way axis (7168 / 4 = 1792):
# prefill 4 x 512, decode 4 rows, training 2 x 512
CARD_CASES = [(4096, 256, 0), (8, 1024, 0), (16, 4096, 0), (4, 40000, 0),
              (64, 100, 1), (2048, 1792, 0), (4, 1792, 0), (1024, 1792, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_split_form_matches_its_plain_version(cuda, case, dtype):
    rows, d, off = case
    x, s, g = (t.to(cuda) for t in _inputs(rows, d + off, dtype=dtype))
    x, g = x[:, off:], g[:, off:]
    s = s[off:].contiguous()
    n = 4 * d
    ss = (x.float().square().sum(-1) * 3.7).contiguous()
    before = dict(rn.launches)
    got = rn.rmsnorm_rows(x, s, EPS, ss, n)
    dx, ds, dss = rn.rmsnorm_rows_bwd(x, s, g, EPS, ss, n)
    assert rn.launches["rmsnorm"] == before["rmsnorm"] + 1
    assert rn.launches["rmsnorm_bwd"] == before["rmsnorm_bwd"] + 1
    want = rmsnorm_ref(x, s, EPS, ss, n)
    w_dx, w_ds, w_dss = rmsnorm_bwd_ref(x, s, g, EPS, ss, n)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    assert _close(got, want, tol)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _close(dx, w_dx, tol)
    assert _close(ds, w_ds, tol)
    assert _close(dss, w_dss, 1e-5)
