"""The port's CUDA kernels against their plain twins on the card: the
min-plus kernels K1/K2 bitwise, RMSNorm (K3) and flash attention (K4) within
the tolerances stated at their tests.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips with a
reason where ``torch.cuda.is_available()`` is false.  The file imports
nothing of JAX, so it runs on a GPU machine that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import batcheval
from repro_torch.core.diameter import adjacency_from_rings
from repro_torch.core.topology import make_latency
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.minplus import kernel, ops, ref
from repro_torch.kernels.rmsnorm import kernel as rn_kernel
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ring_adj(dist, n, seed, k_rings):
    rng = np.random.default_rng(seed)
    w = make_latency(dist, n, seed=seed)
    return adjacency_from_rings(w, [rng.permutation(n)
                                    for _ in range(k_rings)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 13, 17, 29), (3, 20, 33, 17),
                                   (1, 5, 130, 7), (2, 256, 256, 256)])
def test_minplus_acc_bitwise(cuda, dtype, shape):
    bsz, m, k, n = shape
    rng = np.random.default_rng(sum(shape))

    def rand(*s):
        return torch.from_numpy(rng.uniform(0, 10, s).astype(np.float32)) \
            .to(cuda, dtype)

    a, b, c = rand(bsz, m, k), rand(bsz, k, n), rand(bsz, m, n)
    before = kernel.launches["minplus_acc"]
    assert torch.equal(kernel.minplus_acc(a, b), ref.minplus_acc_ref(a, b))
    assert torch.equal(kernel.minplus_acc(a, b, c),
                       ref.minplus_acc_ref(a, b, c))
    out = c.clone()
    kernel.minplus_acc(a, b, init=out, out=out)
    assert torch.equal(out, ref.minplus_acc_ref(a, b, c))
    assert kernel.launches["minplus_acc"] == before + 3


@pytest.mark.parametrize("shape", [(13, 17, 29), (5, 130, 7), (45, 70, 31)])
def test_ops_minplus_unpadded_ragged_bitwise(cuda, shape):
    """ops.minplus / minplus_batched hand ragged operands to K1 as they
    are: K1 masks the edges itself."""
    m, k, n = shape
    rng = np.random.default_rng(m * k * n)
    a = rng.uniform(0, 10, (2, m, k)).astype(np.float32)
    b = rng.uniform(0, 10, (2, k, n)).astype(np.float32)
    a_c, b_c = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    want = ref.minplus_batched_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(ops.minplus_batched(a_c, b_c).cpu(), want)
    assert torch.equal(ops.minplus(a_c[0], b_c[0]).cpu(), want[0])


def test_minplus_acc_strided_views(cuda):
    """Panels are read as views of the distance matrix (row stride N)."""
    d = torch.from_numpy(_ring_adj("fabric", 200, 3, 3)).to(cuda)
    diag = kernel.fw_tile(d[:64, :64])
    got = kernel.minplus_acc(d[None, :, :64], diag[None],
                             init=d[None, :, :64])
    want = ref.minplus_acc_ref(d[None, :, :64], diag[None], d[None, :, :64])
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [8, 152, 256])
def test_fw_tile_bitwise(cuda, dtype, t):
    rng = np.random.default_rng(t)
    m = rng.uniform(1, 100, (t, t)).astype(np.float32)
    m = np.triu(m, 1) + np.triu(m, 1).T
    x = torch.from_numpy(m).to(cuda, dtype)
    assert torch.equal(kernel.fw_tile(x), ref.fw_tile_ref(x))


@pytest.mark.parametrize("symmetric", [False, True])
def test_apsp_tiled_bitwise(cuda, symmetric):
    adj = torch.from_numpy(_ring_adj("uniform", 300, 1, 3)).to(cuda)
    tile = ops.default_tile(300)
    want = ref.apsp_tiled_ref(ops._pad_to(adj, tile, ops.INF), tile,
                              symmetric=symmetric)[:300, :300]
    assert torch.equal(ops.apsp_tiled(adj, symmetric=symmetric), want)


@pytest.mark.parametrize("method", ["squaring", "tiled"])
def test_engine_on_cuda_bit_equal_cpu(cuda, method):
    rng = np.random.default_rng(7)
    w = make_latency("fabric", 300, seed=7)
    genomes = np.stack([[rng.permutation(300) for _ in range(2)]
                        for _ in range(3)])
    want = batcheval.diameters_of_rings(w, genomes, method=method,
                                        device="cpu")
    got = batcheval.diameters_of_rings(w, genomes, method=method)
    assert batcheval.last_eval_report()["device"].startswith("cuda")
    assert np.array_equal(got, want)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    a = torch.zeros(1, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        kernel.minplus_acc(a, a.double())
    with pytest.raises(ValueError, match="unit stride"):
        kernel.minplus_acc(a, a.transpose(1, 2))
    with pytest.raises(ValueError, match="T <= 256"):
        kernel.fw_tile(torch.zeros(264, 264, device=cuda))


# --- K3 rmsnorm -------------------------------------------------------------

def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    mag = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def rmsnorm_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """fp32: |diff| <= 1e-6 * max(1, |want|) (the kernel's 1/sqrtf and
    torch's CUDA rsqrt differ by ulps, summed in another order); bf16: at
    most one bf16 ulp of the value (nearly equal fp32 values may round to
    neighbouring bf16 values)."""
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return bool((err <= 1e-6 * want.float().abs().clamp_min(1.0)).all())
    return bool((err <= _bf16_ulp(want)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64), (7, 1152), (300, 256),
                                   (2, 3, 5, 96), (8192, 1152)])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, shape):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(0, 2, shape).astype(np.float32)) \
        .to(cuda, dtype)
    s = torch.from_numpy(rng.normal(0, 0.1, shape[-1:]).astype(np.float32)) \
        .to(cuda, dtype)
    before = rn_kernel.launches["rmsnorm"]
    got = rn_ops.rmsnorm(x, s, 1e-6)
    assert rn_kernel.launches["rmsnorm"] == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    assert rmsnorm_close(got, rmsnorm_ref(x, s, 1e-6))


def test_rmsnorm_kernel_strided_rows(cuda):
    x = torch.randn(64, 300, device=cuda)[:, :256]      # row stride 300
    s = torch.randn(256, device=cuda) * 0.1
    assert rmsnorm_close(rn_kernel.rmsnorm_rows(x, s), rmsnorm_ref(x, s))


# --- K4 flash attention -----------------------------------------------------

FLASH_CASES = [
    dict(b=1, hq=2, hkv=2, tq=128, tk=128, d=128, causal=True, window=None),
    dict(b=2, hq=4, hkv=2, tq=256, tk=256, d=64, causal=True, window=None),
    dict(b=1, hq=4, hkv=1, tq=200, tk=200, d=80, causal=True, window=96),
    dict(b=1, hq=2, hkv=2, tq=128, tk=384, d=128, causal=False, window=None),
    dict(b=1, hq=8, hkv=2, tq=64, tk=64, d=32, causal=True, window=32),
    dict(b=2, hq=4, hkv=1, tq=1024, tk=1024, d=256, causal=True, window=512),
    dict(b=2, hq=4, hkv=1, tq=1024, tk=1024, d=256, causal=True, window=None),
    dict(b=1, hq=4, hkv=1, tq=37, tk=37, d=16, causal=True, window=16),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_flash_attention_kernel_matches_plain(cuda, case, dtype, tol):
    rng = np.random.default_rng(case["tq"] + case["d"])

    def rand(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)) \
            .to(cuda, dtype)

    q = rand(case["b"], case["hq"], case["tq"], case["d"])
    k = rand(case["b"], case["hkv"], case["tk"], case["d"])
    v = rand(case["b"], case["hkv"], case["tk"], case["d"])
    before = fa_kernel.launches["flash_attention"]
    got = fa_ops.flash_attention(q, k, v, causal=case["causal"],
                                 window=case["window"])
    assert fa_kernel.launches["flash_attention"] == before + 1
    want = attention_ref(q, k, v, causal=case["causal"],
                         window=case["window"])
    assert got.dtype == dtype and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err < tol, (case, dtype, err)


def test_flash_attention_kernel_takes_transposed_views(cuda):
    """The model hands K4 (B, T, H, D) tensors transposed to (B, H, T, D)."""
    q = torch.randn(2, 300, 4, 256, device=cuda).transpose(1, 2)
    k = torch.randn(2, 300, 1, 256, device=cuda).transpose(1, 2)
    v = torch.randn(2, 300, 1, 256, device=cuda).transpose(1, 2)
    got = fa_ops.flash_attention(q, k, v, window=64)
    want = attention_ref(q, k, v, window=64)
    assert float((got - want).abs().max()) < 2e-5


def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, 264, device=cuda)
    with pytest.raises(ValueError, match="D <= 256"):
        fa_ops.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="dtype|float"):
        fa_ops.flash_attention(q, q.double(), q)
    with pytest.raises(ValueError, match="fp32/bf16"):
        rn_ops.rmsnorm(q.double(), torch.zeros(16, device=cuda).double())
