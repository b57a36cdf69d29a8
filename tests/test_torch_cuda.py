"""The port's CUDA kernels against their plain twins on the card: the
min-plus kernels K1/K2 bitwise, RMSNorm (K3) and flash attention (K4) and
their gradients (K3b, K4b), Mamba1's selective scan (K5) and decode
attention over a KV cache (K6), within the tolerances stated at their
tests; the MoE layer's dispatch on the card
against the CPU port and against itself (bitwise, forward and backward);
and one Mamba1 and one Mamba2 layer on the card against the CPU port.

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
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref,
                                                     attention_ref)
from repro_torch.kernels.minplus import kernel, ops, ref
from repro_torch.kernels.rmsnorm import kernel as rn_kernel
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

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


# K1 at sizes below and around its tiles (64, 128) and slices (16)
K1_RAGGED = [(1, 1, 1, 1), (2, 7, 63, 65), (1, 63, 65, 7), (3, 65, 127, 129),
             (1, 127, 129, 255), (2, 129, 255, 127), (1, 255, 257, 1),
             (1, 257, 7, 257)]


def _k1_operands(cuda, dtype, shape, seed):
    """Negative and positive operands, a row of A and a column of B at
    +inf, and an init with a row at +inf."""
    bsz, m, k, n = shape
    rng = np.random.default_rng(seed)

    def rand(*s):
        return torch.from_numpy(rng.uniform(-20, 50, s).astype(np.float32)) \
            .to(cuda, dtype)

    a, b, c = rand(bsz, m, k), rand(bsz, k, n), rand(bsz, m, n)
    a[-1, m // 2, :] = float("inf")
    b[0, :, n // 2] = float("inf")
    c[0, (m - 1) // 2, :] = float("inf")
    return a, b, c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K1_RAGGED)
@pytest.mark.parametrize("choice", kernel.MINPLUS_VARIANTS)
def test_minplus_acc_every_variant_bitwise(cuda, choice, shape, dtype):
    """Every (tile, k chunks) K1 is built for, at ragged sizes: without
    init, with init, and in place (init = out)."""
    a, b, c = _k1_operands(cuda, dtype, shape, sum(shape) + choice[1])
    want = ref.minplus_acc_ref(a, b, c)
    before = kernel.launches["minplus_acc"]
    assert torch.equal(kernel.minplus_acc(a, b, choice=choice),
                       ref.minplus_acc_ref(a, b))
    assert torch.equal(kernel.minplus_acc(a, b, c, choice=choice), want)
    out = c.clone()
    kernel.minplus_acc(a, b, init=out, out=out, choice=choice)
    assert torch.equal(out, want)
    assert kernel.launches["minplus_acc"] == before + 3


@pytest.mark.parametrize("choice", kernel.MINPLUS_VARIANTS)
def test_minplus_acc_every_variant_strided_panels(cuda, choice):
    """The blocked Floyd-Warshall's panels as views of one matrix (row
    stride N): the row panel (diag x rows), the column panel (columns x
    diag), and the outer update in place, at N = 300, T = 152."""
    d = torch.from_numpy(_ring_adj("fabric", 300, 5, 3)).to(cuda)
    t = 152
    diag = kernel.fw_tile(d[:t, :t])
    rows, cols = d[None, :t, :], d[None, :, :t]
    assert torch.equal(kernel.minplus_acc(diag[None], rows, init=rows,
                                          choice=choice),
                       ref.minplus_acc_ref(diag[None], rows, rows))
    assert torch.equal(kernel.minplus_acc(cols, diag[None], init=cols,
                                          choice=choice),
                       ref.minplus_acc_ref(cols, diag[None], cols))
    colp, rowp = cols.clone(), rows.clone()      # the frozen panels
    want = ref.minplus_acc_ref(colp, rowp, d[None])
    kernel.minplus_acc(colp, rowp, init=d[None], out=d[None], choice=choice)
    assert torch.equal(d[None], want)


def test_minplus_acc_chosen_variants_at_the_path_shapes(cuda):
    """The variant :func:`kernel.variant` picks at each shape the paths
    give K1, bitwise against the plain version (small batches of the
    same shapes keep the plain version fast)."""
    for shape in [(1, 256, 256, 4096), (4, 256, 256, 256), (1, 256, 256, 256),
                  (1, 4096, 256, 256)]:
        a, b, c = _k1_operands(cuda, torch.float32, shape, shape[0])
        assert kernel.variant(*shape) in kernel.MINPLUS_VARIANTS
        assert torch.equal(kernel.minplus_acc(a, b, c),
                           ref.minplus_acc_ref(a, b, c)), shape


FW_TILE_TS = [1, 7, 8, 31, 33, 152, 200, 255, 256]


def _tile(t, seed, symmetric=True):
    rng = np.random.default_rng(seed)
    m = rng.uniform(1, 100, (t, t)).astype(np.float32)
    if symmetric:
        m = np.triu(m, 1) + np.triu(m, 1).T
    return m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", FW_TILE_TS)
def test_fw_tile_bitwise(cuda, dtype, t):
    x = torch.from_numpy(_tile(t, t)).to(cuda, dtype)
    before = kernel.launches["fw_tile"]
    assert torch.equal(kernel.fw_tile(x), ref.fw_tile_ref(x))
    assert kernel.launches["fw_tile"] == before + 1
    y = torch.from_numpy(_tile(t, t + 1, symmetric=False)).to(cuda, dtype)
    assert torch.equal(kernel.fw_tile(y), ref.fw_tile_ref(y))


@pytest.mark.parametrize("variant", kernel.FW_TILE_VARIANTS)
@pytest.mark.parametrize("t", [7, 8, 33, 200, 255, 256])
def test_fw_tile_every_variant_bitwise(cuda, variant, t):
    x = torch.from_numpy(_tile(t, 3 * t, symmetric=False)).to(cuda)
    assert torch.equal(kernel.fw_tile_variant(x, *variant),
                       ref.fw_tile_ref(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [152, 200, 256])
def test_fw_tile_strided_view_and_inf(cuda, dtype, t):
    """A diagonal tile read in place from a larger matrix (row stride 300),
    with padding rows and columns (ops.INF) and a disconnected node (inf)."""
    d = torch.from_numpy(_ring_adj("fabric", 300, t, 2)).to(cuda, dtype)
    d[t - 5:, :] = ops.INF
    d[:, t - 5:] = ops.INF
    d[3, :] = float("inf")
    d[:, 3] = float("inf")
    d.fill_diagonal_(0.0)
    view = d[:t, :t]
    assert view.stride(0) == 300
    assert torch.equal(kernel.fw_tile(view), ref.fw_tile_ref(view))


@pytest.mark.parametrize("n", [300, 600])
@pytest.mark.parametrize("symmetric", [False, True])
def test_apsp_tiled_bitwise(cuda, symmetric, n):
    adj = torch.from_numpy(_ring_adj("uniform", n, 1, 3)).to(cuda)
    if not symmetric:
        adj[::7, 1::5] = 1.0           # some one-way shortcuts
    tile = ops.default_tile(n)
    want = ref.apsp_tiled_ref(ops._pad_to(adj, tile, ops.INF), tile,
                              symmetric=symmetric)[:n, :n]
    assert torch.equal(ops.apsp_tiled(adj, symmetric=symmetric), want)


def test_cluster_barrier_probe(cuda):
    for cluster in (2, 4, 8, 16):
        cycles, ns = kernel.cluster_barrier_cycles(cluster, iters=1000)
        assert 0 < cycles < 1e5 and 0 < ns < 1e5


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
    with pytest.raises(ValueError, match="built for"):
        kernel.fw_tile_variant(torch.zeros(8, 8, device=cuda), 32, 1)


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


RMS_DS = [1, 3, 96, 256, 1150, 1152, rn_kernel.D_MAX, rn_kernel.D_MAX + 1,
          8192]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 7, 8, 9, 32768])
@pytest.mark.parametrize("d", RMS_DS)
def test_rmsnorm_kernel_every_width(cuda, dtype, rows, d):
    """Every width, at row counts that fill, overfill and underfill a block
    of 8 rows: rows that start on a 16-byte boundary, and the same rows one
    element off it (which take the scalar variant)."""
    g = torch.Generator(device=cuda).manual_seed(rows * d)
    buf = (torch.randn(rows * d + 1, device=cuda, generator=g) * 2).to(dtype)
    s = (torch.randn(d, device=cuda, generator=g) * 0.1).to(dtype)
    for x in (buf[:-1].view(rows, d), buf[1:].view(rows, d)):
        before = rn_kernel.launches["rmsnorm"]
        got = rn_kernel.rmsnorm_rows(x, s)
        assert rn_kernel.launches["rmsnorm"] == before + 1
        assert got.shape == x.shape and got.dtype == dtype
        assert rmsnorm_close(got, rmsnorm_ref(x, s)), rn_kernel.variant(x, s)


def test_rmsnorm_kernel_takes_each_variant(cuda):
    """The four variants of K3 are chosen as documented, and each holds:
    "warp" for many rows of d <= D_MAX, "block" for few rows or wider
    ones, "loop" only past what a block of 32 warps holds, "scalar" for
    unaligned rows."""
    x = torch.randn(64, 301, device=cuda)               # row stride 301
    s = torch.randn(301, device=cuda) * 0.1
    wide = 32 * rn_kernel.BLOCK_WARPS * rn_kernel.BLOCK_NV * 4 + 4
    cases = {
        "warp": (torch.randn(rn_kernel.WARP_ROWS, 256, device=cuda),
                 s[:256].contiguous()),
        "block": (torch.randn(9, 4096, device=cuda),
                  torch.randn(4096, device=cuda) * 0.1),
        "loop": (torch.randn(3, wide, device=cuda),
                 torch.randn(wide, device=cuda) * 0.1),
        "scalar": (x[:, :256], s[:256].contiguous()),
    }
    for kind, (xx, ss) in cases.items():
        assert rn_kernel.variant(xx, ss)[0] == kind
        before = rn_kernel.launches["rmsnorm"]
        assert rmsnorm_close(rn_kernel.rmsnorm_rows(xx, ss),
                             rmsnorm_ref(xx, ss))
        assert rn_kernel.launches["rmsnorm"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 7, 8, 9, 33])
@pytest.mark.parametrize("d", [2048, 2056, 3584, 5120, 7168, 8192])
def test_rmsnorm_kernel_block_variant(cuda, dtype, rows, d):
    """K3's "block" variant (a row over up to 32 warps, in registers) at
    the decode row counts and the served widths, and the same rows with a
    row stride one element off 16 bytes, which stay "scalar"."""
    g = torch.Generator(device=cuda).manual_seed(rows + d)
    s = (torch.randn(d, device=cuda, generator=g) * 0.1).to(dtype)
    ld = d + 1
    buf = (torch.randn(rows * ld, device=cuda, generator=g) * 2).to(dtype)
    for x, kind in ((buf[:rows * d].view(rows, d), "block"),
                    (buf.view(rows, ld)[:, :d], "scalar")):
        assert rn_kernel.variant(x, s)[0] == kind
        before = rn_kernel.launches["rmsnorm"]
        got = rn_kernel.rmsnorm_rows(x, s)
        assert rn_kernel.launches["rmsnorm"] == before + 1
        assert rmsnorm_close(got, rmsnorm_ref(x, s)), (kind, rows, d)


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
    # moonshot-v1-16b-a3b's layer: D = 128, Hq = Hkv = 16
    dict(b=2, hq=16, hkv=16, tq=1024, tk=1024, d=128, causal=True,
         window=None),
]

# K4's tensor-core instances (D <= 64, D <= 128; 128 query rows a block,
# 64-key tiles): D = 64, 112, 128 at Hq / Hkv 1 and 4; Tq and Tk one short
# of and one past a query tile and a KV tile; D = 100 and 127 (staged
# element by element); a window ending inside a KV tile; rows that see no
# key (fully masked: 0)
TC_CASES = [
    dict(b=2, hq=4, hkv=4, tq=256, tk=256, d=64, causal=True, window=None),
    dict(b=1, hq=8, hkv=2, tq=256, tk=256, d=64, causal=True, window=None),
    dict(b=2, hq=4, hkv=4, tq=200, tk=200, d=112, causal=True, window=None),
    dict(b=1, hq=8, hkv=2, tq=200, tk=200, d=112, causal=True, window=None),
    dict(b=1, hq=4, hkv=4, tq=256, tk=256, d=128, causal=True, window=None),
    dict(b=1, hq=8, hkv=2, tq=256, tk=256, d=128, causal=True, window=None),
    dict(b=1, hq=2, hkv=1, tq=127, tk=127, d=128, causal=True, window=None),
    dict(b=1, hq=2, hkv=1, tq=129, tk=129, d=64, causal=True, window=None),
    dict(b=1, hq=2, hkv=2, tq=129, tk=63, d=112, causal=False, window=None),
    dict(b=1, hq=2, hkv=2, tq=127, tk=65, d=128, causal=False, window=None),
    dict(b=2, hq=4, hkv=1, tq=300, tk=300, d=100, causal=True, window=None),
    dict(b=1, hq=2, hkv=2, tq=129, tk=129, d=127, causal=True, window=None),
    dict(b=1, hq=4, hkv=2, tq=300, tk=300, d=128, causal=True, window=90),
    dict(b=1, hq=2, hkv=1, tq=200, tk=40, d=64, causal=True, window=20),
]


@pytest.mark.parametrize("case", FLASH_CASES + TC_CASES,
                         ids=lambda c: "-".join(f"{k}{v}"
                                                for k, v in c.items()))
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


# K4 at the edges of its KV tiles and stages (64 keys) and D buckets (128,
# 256)
FLASH_RAGGED = [
    # Tk below a stage, one past one and two stages, and inside the fifth
    dict(b=1, hq=2, hkv=1, tq=45, tk=45, d=16, causal=True, window=None),
    dict(b=1, hq=2, hkv=1, tq=65, tk=65, d=128, causal=True, window=None),
    dict(b=1, hq=2, hkv=1, tq=129, tk=129, d=256, causal=True, window=None),
    dict(b=1, hq=2, hkv=1, tq=300, tk=300, d=256, causal=True, window=None),
    # windows that end inside a stage, on its edge and one past it
    dict(b=1, hq=2, hkv=2, tq=100, tk=100, d=80, causal=True, window=40),
    dict(b=1, hq=2, hkv=1, tq=600, tk=600, d=256, causal=True, window=300),
    dict(b=1, hq=2, hkv=1, tq=300, tk=300, d=256, causal=True, window=64),
    dict(b=1, hq=2, hkv=1, tq=300, tk=300, d=128, causal=True, window=65),
    # D = 16, 80, 200, 255 (not a multiple of 4: element-by-element loads)
    dict(b=1, hq=1, hkv=1, tq=33, tk=33, d=200, causal=True, window=None),
    dict(b=2, hq=4, hkv=2, tq=257, tk=257, d=255, causal=True, window=None),
    # 8:1 GQA
    dict(b=1, hq=8, hkv=1, tq=70, tk=70, d=64, causal=True, window=None),
    # Tq < Tk, not causal
    dict(b=2, hq=2, hkv=1, tq=20, tk=97, d=80, causal=False, window=None),
    dict(b=1, hq=2, hkv=1, tq=130, tk=700, d=256, causal=False, window=None),
    # Tq > Tk with a window: rows 23.. see no key (fully masked, 0)
    dict(b=1, hq=2, hkv=1, tq=64, tk=16, d=16, causal=True, window=8),
    # the same past a query tile of the tensor-core instances, at D = 112
    dict(b=1, hq=2, hkv=1, tq=200, tk=40, d=112, causal=True, window=20),
]


@pytest.mark.parametrize("case", FLASH_RAGGED, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_flash_attention_kernel_ragged_pieces(cuda, case, dtype, tol):
    test_flash_attention_kernel_matches_plain(cuda, case, dtype, tol)
    if case["window"] and case["tq"] > case["tk"] + case["window"]:
        q = torch.ones(1, 1, case["tq"], case["d"], device=cuda, dtype=dtype)
        k = torch.ones(1, 1, case["tk"], case["d"], device=cuda, dtype=dtype)
        got = fa_ops.flash_attention(q, k, k, window=case["window"])
        assert not got[:, :, case["tk"] + case["window"]:].any()


def test_flash_attention_kernel_takes_transposed_views(cuda):
    """The model hands K4 (B, T, H, D) tensors transposed to (B, H, T, D)."""
    q = torch.randn(2, 300, 4, 256, device=cuda).transpose(1, 2)
    k = torch.randn(2, 300, 1, 256, device=cuda).transpose(1, 2)
    v = torch.randn(2, 300, 1, 256, device=cuda).transpose(1, 2)
    got = fa_ops.flash_attention(q, k, v, window=64)
    want = attention_ref(q, k, v, window=64)
    assert float((got - want).abs().max()) < 2e-5


# --- K4 with L, K4b ----------------------------------------------------------

def grad_close(got: torch.Tensor, want: torch.Tensor) -> float:
    """Gradients against their plain twin: fp32 within 5e-5 x max(1,
    max |want|) (sums of up to Tq x D products taken in another order);
    bf16 within one bf16 ulp of each value plus 1e-3 x max(1, max |want|)
    (fp32 sums rounded to bf16 once, the last bits moved by the order)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs()
    top = max(1.0, float(want.float().abs().max()))
    if got.dtype == torch.float32:
        ok = bool((err <= 5e-5 * top).all())
    else:
        ok = bool((err <= _bf16_ulp(want) + 1e-3 * top).all())
    assert ok and bool(torch.isfinite(got.float()).all()), float(err.max())
    return float(err.max())


BWD_CASES = FLASH_CASES[:6] + [FLASH_RAGGED[i]
                                for i in (2, 5, 8, 9, 11, 13)] + [
    # K4b's tiles (64 resident rows, 16-row steps): an odd count of key
    # tiles under the causal mask, Tk one past a tile, 8:1 GQA at D = 256
    # (the per-head partials' fixed-order sum), a window ending inside a
    # step, and the training shape (its bf16 case has a bf16 dO)
    dict(b=1, hq=2, hkv=1, tq=320, tk=320, d=256, causal=True, window=None),
    dict(b=2, hq=2, hkv=2, tq=65, tk=65, d=128, causal=True, window=None),
    dict(b=1, hq=8, hkv=1, tq=200, tk=200, d=256, causal=True, window=None),
    dict(b=1, hq=4, hkv=2, tq=300, tk=300, d=128, causal=True, window=100),
    dict(b=4, hq=4, hkv=1, tq=1024, tk=1024, d=256, causal=True, window=None),
    # moonshot-v1-16b-a3b's training shape (D = 128, Hq = Hkv = 16)
    dict(b=4, hq=16, hkv=16, tq=1024, tk=1024, d=128, causal=True,
         window=None),
]


def _attn_inputs(cuda, case, dtype, seed):
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)) \
            .to(cuda, dtype)

    return (rand(case["b"], case["hq"], case["tq"], case["d"]),
            rand(case["b"], case["hkv"], case["tk"], case["d"]),
            rand(case["b"], case["hkv"], case["tk"], case["d"]),
            rand(case["b"], case["hq"], case["tq"], case["d"]))


@pytest.mark.parametrize("case", BWD_CASES + TC_CASES,
                         ids=lambda c: "-".join(f"{k}{v}"
                                                for k, v in c.items()))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_lse_leaves_the_output_bitwise(cuda, case, dtype):
    """K4 with its L written gives the serving output bit for bit; L holds
    to the plain version's within 1e-5 x max(1, |L|) (fp32) or 1e-2
    (bf16 inputs), -1e30 on a fully masked row alike."""
    q, k, v, _ = _attn_inputs(cuda, case, dtype, case["tq"] + case["d"])
    kw = dict(scale=case["d"] ** -0.5, causal=case["causal"],
              window=case["window"])
    plain_out = fa_kernel.flash_attention(q, k, v, **kw)
    out, lse = fa_kernel.flash_attention(q, k, v, with_lse=True, **kw)
    assert torch.equal(out, plain_out)
    _, want = attention_fwd_ref(q, k, v, **kw)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    assert bool(((lse - want).abs() <= tol * want.abs().clamp_min(1.0))
                .all()), float((lse - want).abs().max())


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_matches_plain(cuda, case, dtype):
    """K4b against ``attention_bwd_ref`` on the same q, k, v, K4's o and L,
    and dO; two calls bitwise equal; a fully masked row's dq zero."""
    q, k, v, do = _attn_inputs(cuda, case, dtype, 7 * case["tq"] + case["d"])
    kw = dict(scale=case["d"] ** -0.5, causal=case["causal"],
              window=case["window"])
    out, lse = fa_kernel.flash_attention(q, k, v, with_lse=True, **kw)
    before = fa_kernel.launches["flash_attention_bwd"]
    got = fa_kernel.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert fa_kernel.launches["flash_attention_bwd"] == before + 1
    want = attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for g, w in zip(got, want):
        grad_close(g, w)
    again = fa_kernel.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if case["window"] and case["tq"] > case["tk"] + case["window"]:
        assert not got[0][:, :, case["tk"] + case["window"]:].any()


@pytest.mark.parametrize("window", [None, 512])
def test_flash_attention_bwd_does_not_lean(cuda, window):
    """At the training shape K4b's fp32 gradients lean from the float64
    ones by at most 5e-6 (|sum(got exact) / sum(exact^2) - 1|): a sum kept
    in one tensor-core accumulator drifts toward zero, which max |diff|
    does not show and a model's gradient norm does."""
    case = dict(b=4, hq=4, hkv=1, tq=1024, tk=1024, d=256)
    q, k, v, do = _attn_inputs(cuda, case, torch.float32, 19)
    kw = dict(scale=0.0625, causal=True, window=window)
    out, lse = fa_kernel.flash_attention(q, k, v, with_lse=True, **kw)
    got = fa_kernel.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    exact = attention_bwd_ref(*(x.double() for x in (q, k, v, out, lse, do)),
                              **kw)
    for g, e in zip(got, exact):
        lean = float((g.double() * e).sum() / (e * e).sum() - 1.0)
        assert abs(lean) <= 5e-6, lean


@pytest.mark.parametrize("shape", [(8, 16, 1024, 128), (8, 32, 1024, 64)],
                         ids=["moonshot", "musicgen"])
def test_flash_attention_does_not_lean(cuda, shape):
    """At moonshot's and musicgen's served layers K4's fp32 output leans
    from the float64 one by at most 5e-6 (|sum(got exact) / sum(exact^2)
    - 1|): the tensor-core instances' accumulators must not drift toward
    zero, which max |diff| does not show and a model's output does."""
    b, h, t, d = shape
    case = dict(b=b, hq=h, hkv=h, tq=t, tk=t, d=d)
    q, k, v, _ = _attn_inputs(cuda, case, torch.float32, 23)
    got = fa_kernel.flash_attention(q, k, v, scale=d ** -0.5, causal=True)
    exact = attention_ref(q.double(), k.double(), v.double(),
                          scale=d ** -0.5)
    lean = float((got.double() * exact).sum() / (exact * exact).sum() - 1.0)
    assert abs(lean) <= 5e-6, lean


def test_flash_attention_function_grads_through_transposed_views(cuda):
    """``ops.flash_attention`` under autograd, on the (B, T, H, D) views
    the model hands it: K4 + K4b against autograd of the plain forward."""
    torch.manual_seed(0)
    base = [torch.randn(2, 300, h, 256, device=cuda, requires_grad=True)
            for h in (4, 1, 1)]
    do = torch.randn(2, 4, 300, 256, device=cuda)
    before = dict(fa_kernel.launches)
    out = fa_ops.flash_attention(*(x.transpose(1, 2) for x in base),
                                 window=64)
    got = torch.autograd.grad(out, base, do)
    assert fa_kernel.launches["flash_attention"] == \
        before["flash_attention"] + 1
    assert fa_kernel.launches["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    want = torch.autograd.grad(attention_ref(
        *(x.transpose(1, 2) for x in base), window=64), base, do)
    for g, w in zip(got, want):
        grad_close(g, w)


# --- K3b --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,off", [(7, 1152, 0), (4096, 1152, 0),
                                        (16384, 256, 0), (300, 256, 1),
                                        (5, 8192, 0), (9, 3, 0),
                                        (33, 1150, 0),
                                        # rows no multiple of a block's
                                        # chunk; d either side of D_MAX
                                        (4097, 1152, 0), (9, 256, 0),
                                        (1001, rn_kernel.D_MAX, 0),
                                        (1001, rn_kernel.D_MAX + 8, 0),
                                        # moonshot's training rows
                                        (4096, rn_kernel.D_MAX, 0)])
def test_rmsnorm_bwd_matches_plain(cuda, dtype, rows, d, off):
    """K3b against ``rmsnorm_bwd_ref`` (dx and dscale, see
    :func:`grad_close`), rows on and one element off a 16-byte boundary;
    two calls bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(rows + d)
    x = (torch.randn(rows * d + off, device=cuda, generator=gen) * 2) \
        .to(dtype)[off:].view(rows, d)
    g = torch.randn(rows, d, device=cuda, generator=gen).to(dtype)
    s = (torch.randn(d, device=cuda, generator=gen) * 0.1).to(dtype)
    before = rn_kernel.launches["rmsnorm_bwd"]
    got = rn_kernel.rmsnorm_rows_bwd(x, s, g)
    assert rn_kernel.launches["rmsnorm_bwd"] == before + 1
    for a, b in zip(got, rmsnorm_bwd_ref(x, s, g)):
        grad_close(a, b)
    again = rn_kernel.rmsnorm_rows_bwd(x, s, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_rmsnorm_bwd_takes_each_variant(cuda):
    """The four variants of K3b are chosen as documented, and each holds
    (two calls bitwise): "block" at the widths past D_MAX (2056, the SSM
    widths 3584 / 4096 / 7168, 8192) in fp32 and bf16 at 1, 8 and 4096
    rows, "loop" only past what a block holds, "scalar" one element off a
    16-byte boundary (also when only g's rows are)."""
    x = torch.randn(64, 301, device=cuda)               # row stride 301
    s = torch.randn(301, device=cuda) * 0.1
    g = torch.randn(64, 301, device=cuda)
    cases = [
        ("warp", x[:, :256].contiguous(), s[:256].contiguous(),
         g[:, :256].contiguous()),
        ("loop", torch.randn(3, 16392, device=cuda),
         torch.randn(16392, device=cuda) * 0.1,
         torch.randn(3, 16392, device=cuda)),
        ("scalar", x[:, :256], s[:256].contiguous(), g[:, :256].contiguous()),
        ("scalar", x[:, :256].contiguous(), s[:256].contiguous(), g[:, :256]),
    ]
    for dt in (torch.float32, torch.bfloat16):
        for d in (2056, 3584, 4096, 7168, 8192):
            for rows in (1, 8, 4096):
                cases.append(("block", torch.randn(rows, d, device=cuda)
                              .to(dt) * 2, (torch.randn(d, device=cuda)
                                            * 0.1).to(dt),
                              torch.randn(rows, d, device=cuda).to(dt)))
        buf = torch.randn(9 * 4096 + 1, device=cuda).to(dt)
        cases.append(("scalar", buf[1:].view(9, 4096),
                      (torch.randn(4096, device=cuda) * 0.1).to(dt),
                      torch.randn(9, 4096, device=cuda).to(dt)))
    for kind, xx, ss, gg in cases:
        assert rn_kernel.variant(xx, ss, gg)[0] == kind, (kind, xx.shape)
        before = rn_kernel.launches["rmsnorm_bwd"]
        got = rn_kernel.rmsnorm_rows_bwd(xx, ss, gg)
        assert rn_kernel.launches["rmsnorm_bwd"] == before + 1
        for a, b in zip(got, rmsnorm_bwd_ref(xx, ss, gg)):
            grad_close(a, b)
        again = rn_kernel.rmsnorm_rows_bwd(xx, ss, gg)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_rmsnorm_function_grads_match_autograd_of_plain(cuda):
    """``ops.rmsnorm`` under autograd (K3 + K3b) on q-norm-shaped input
    against autograd of the plain forward."""
    torch.manual_seed(1)
    x = torch.randn(4, 64, 4, 256, device=cuda, requires_grad=True)
    s = (torch.randn(256, device=cuda) * 0.1).requires_grad_()
    g = torch.randn(4, 64, 4, 256, device=cuda)
    got = torch.autograd.grad(rn_ops.rmsnorm(x, s, 1e-6), (x, s), g)
    want = torch.autograd.grad(rmsnorm_ref(x, s, 1e-6), (x, s), g)
    for a, b in zip(got, want):
        grad_close(a, b)


def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, 264, device=cuda)
    with pytest.raises(ValueError, match="D <= 256"):
        fa_ops.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="dtype|float"):
        fa_ops.flash_attention(q, q.double(), q)
    with pytest.raises(ValueError, match="fp32/bf16"):
        rn_ops.rmsnorm(q.double(), torch.zeros(16, device=cuda).double())


# ---------------------------------------------------------------------------
# the deep-Q constructor and partitioned construction on the card, against
# the port's own CPU path (TF32 off: the Q-network must stay in true fp32)
# ---------------------------------------------------------------------------

@pytest.fixture
def fp32_matmul(cuda):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32 = saved


def _qparams(device, p=16, h=64, seed=0):
    from repro_torch.core.embedding import init_qparams
    return init_qparams(torch.Generator().manual_seed(seed), p, h,
                        device=device)


def _close_params(got, want, rtol):
    for k, v in want.tensors().items():
        torch.testing.assert_close(getattr(got, k).detach().cpu(),
                                   v.detach().cpu(), rtol=rtol, atol=1e-5)


def _replay_on_cpu(params, ws, plan, eps, k, actions, n_rounds=3,
                   alpha=0.1):
    """Replay a card rollout's whole trajectory on the CPU.  Every random
    pick must be the plan's ``floor(u * n_unvisited)``-th unvisited node,
    every closing step the ring's start, and every greedy pick a CPU argmax
    within 1e-5 x max |Q| (cuBLAS and the CPU's BLAS sum in other orders,
    so the two best Q values of an untrained network can swap; TF32 would
    miss that bound by two orders).  Returns the rewards and the final
    diameter recomputed on the CPU along the card's own actions."""
    from repro_torch.core import rollout
    from repro_torch.core.embedding import q_values_batch

    e, n = ws.shape[0], ws.shape[1]
    w = torch.from_numpy(ws)
    dist, adj, _, v, _, prev_d = rollout._episode_init(e, n, "cpu")
    rewards = torch.empty(k * n, e)
    for t in range(k * n):
        rt = t % n
        if rt == 0:
            start = torch.as_tensor(plan.starts[:, t // n], dtype=torch.int64)
            visited, v = rollout._onehot(start, n), start
        a = actions[t]
        if rt == n - 1:
            assert torch.equal(a, start), t
        else:
            with torch.no_grad():
                q = q_values_batch(params, w, adj, v, n_rounds)
            q = q.masked_fill(visited, float("-inf"))
            for i in range(e):
                if plan.eps_u[t, i] < eps:
                    unvis = np.flatnonzero(~visited[i].numpy())
                    r = int(np.float32(plan.choice_u[t, i])
                            * np.float32(len(unvis)))
                    assert int(a[i]) == unvis[min(r, len(unvis) - 1)], (t, i)
                else:
                    qi = q[i][~visited[i]]
                    scale = max(1.0, float(qi.abs().max()))
                    margin = float(qi.max() - q[i, a[i]])
                    assert margin <= 1e-5 * scale, (t, i, margin, scale)
        dist, adj, prev_d, rewards[t] = rollout._apply_edge(
            w, dist, adj, v, a, prev_d, alpha)
        visited = visited | rollout._onehot(a, n)
        if rt != n - 1:
            v = a
    return rewards, prev_d


@pytest.mark.parametrize("n,n_envs,k,eps", [(512, 1, 1, 0.3),
                                            (64, 4, 2, 0.0)])
def test_rollout_on_card_matches_cpu(fp32_matmul, n, n_envs, k, eps):
    """The card's whole trajectory replayed on the CPU (see
    :func:`_replay_on_cpu`), its rewards and final diameter held to the
    CPU's recomputation along the same actions.  Where no near tie is met
    (N=64, E=4) a fresh CPU rollout takes the card's actions exactly."""
    from repro_torch.core import rollout

    ws = np.stack([make_latency("fabric", n, seed=i) for i in range(n_envs)])
    plan = rollout.make_plan(np.random.default_rng(n), n_envs, k, n)
    a_g, r_g, d_g = (x.cpu() for x in rollout.rollout_episodes(
        _qparams(fp32_matmul), torch.as_tensor(ws, device=fp32_matmul),
        plan.starts, plan.eps_u, plan.choice_u, eps, 0.1, k_rings=k))
    r_c, d_c = _replay_on_cpu(_qparams("cpu"), ws, plan, eps, k, a_g)
    torch.testing.assert_close(r_g, r_c, rtol=0, atol=1e-4)
    torch.testing.assert_close(d_g, d_c, rtol=1e-5, atol=0)
    if n_envs > 1:
        a_c, _, _ = rollout.rollout_episodes(
            _qparams("cpu"), torch.from_numpy(ws), plan.starts, plan.eps_u,
            plan.choice_u, eps, 0.1, k_rings=k)
        assert torch.equal(a_g, a_c)


def test_train_epoch_on_card_matches_cpu_without_host_syncs(fp32_matmul):
    """One epoch at eps = 1.0 on both devices: same actions and buffer,
    parameters within rtol 1e-4.  With its inputs already on the card the
    step loop never waits for the device (sync debug mode counts)."""
    import warnings

    from repro_torch.core import rollout
    from repro_torch.train.optimizer import adamw_init

    n, n_envs, k, cap, batch = 48, 2, 2, 100, 16
    ws = np.stack([make_latency("uniform", n, seed=30 + i)
                   for i in range(n_envs)]).astype(np.float32)
    plan = rollout.make_plan(np.random.default_rng(4), n_envs, k, n,
                             updates_per_step=1, batch_size=batch)
    slots = rollout.graph_slots(cap, n_envs, k, n)
    out = {}
    for dev in ("cpu", fp32_matmul):
        params = _qparams(dev, 8, 16)
        args = [torch.as_tensor(x, device=dev) for x in
                (ws, np.arange(n_envs), plan.starts, plan.eps_u,
                 plan.choice_u, plan.sample_u)]
        buf = rollout.init_buffer(cap, n, slots, device=dev)
        opt = adamw_init(params.tensors())
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            if str(dev) == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("warn")
            try:
                res = rollout.train_epoch(
                    params, opt, buf, *args, 1.0, 0.99, 5e-4, 0.1, k_rings=k,
                    n_rounds=2, batch_size=batch, updates_per_step=1)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in seen if "synchroniz" in str(w.message)]
        out[str(dev)] = res, syncs
    (p_c, _, b_c, d_c, l_c, a_c, _), _ = out["cpu"]
    (p_g, _, b_g, d_g, l_g, a_g, _), syncs = out["cuda"]
    assert syncs == [], [str(w.message) for w in syncs[:3]]
    assert torch.equal(a_g.cpu(), a_c)
    assert (b_g.size, b_g.ptr) == (b_c.size, b_c.ptr)
    for name in ("widx", "adj", "v", "action", "adj_next", "visited_next"):
        assert torch.equal(getattr(b_g, name).cpu(), getattr(b_c, name))
    _close_params(p_g, p_c, 1e-4)
    torch.testing.assert_close(l_g.cpu(), l_c, rtol=1e-4, atol=1e-5,
                               equal_nan=True)
    torch.testing.assert_close(d_g.cpu(), d_c, rtol=1e-5, atol=0)


@pytest.mark.parametrize("stitch", ["naive", "scored"])
def test_parallel_ring_scored_on_card_matches_cpu(cuda, stitch):
    """N=512, M=8.  The CPU scores the stitch candidates with the tiled
    method's plain twins, which are bitwise the card's K2 + K1."""
    from repro_torch.core import parallel

    w = make_latency("fabric", 512, seed=0)
    before = dict(kernel.launches)
    ring_g, sc_g = parallel.parallel_ring_scored(w, 8, seed=3,
                                                 score_blocks=True,
                                                 stitch=stitch)
    with batcheval.eval_options(device="cpu", method="tiled"):
        ring_c, sc_c = parallel.parallel_ring_scored(w, 8, seed=3,
                                                     score_blocks=True,
                                                     stitch=stitch)
        assert np.array_equal(parallel.parallel_ring_host(w, 8, seed=3,
                                                          stitch=stitch),
                              ring_c)
    assert np.array_equal(ring_g, ring_c)
    np.testing.assert_allclose(sc_g, sc_c, rtol=1e-6, atol=0)
    if stitch == "scored":
        assert kernel.launches["fw_tile"] > before["fw_tile"]


# --- the churn engine (repro_torch.dynamics) ---------------------------------

def test_churn_replay_on_card_bitwise_cpu_every_event(cuda):
    """poisson_churn at n0=96 under DGRO, event by event on the card and
    on the CPU port.  The CPU runs the card's APSP method (squaring: K1's
    plain twin, bitwise equal); relax, join and tombstone are elementwise
    fp32 in the same order, so the maintained state is bitwise equal
    after every event and every adapt decision is the same."""
    from repro_torch.dynamics import ChurnEngine, DGROPolicy, scenarios

    trace = scenarios.poisson_churn(n0=96, seed=0)
    on_cpu = dict(device="cpu", method="squaring")
    card = ChurnEngine(trace, DGROPolicy(adapt_every=3), seed=0)
    with batcheval.eval_options(**on_cpu):
        cpu = ChurnEngine(trace, DGROPolicy(adapt_every=3), seed=0)
    assert card.inc._dist.is_cuda and not cpu.inc._dist.is_cuda
    for i, e in enumerate(sorted(trace.events, key=lambda e: e.time)):
        card.process(e)
        with batcheval.eval_options(**on_cpu):
            cpu.process(e)
        assert torch.equal(card.inc._dist.cpu(), cpu.inc._dist), i
        assert np.array_equal(card.inc.adj, cpu.inc.adj), i
        assert card.inc.stats == cpu.inc.stats, i
        assert card.policy.adaptations == cpu.policy.adaptations, i
        assert card.inc.diameter() == cpu.inc.diameter(), i
    with batcheval.eval_options(**on_cpu):
        d_cpu = cpu.inc.diameter(exact=True)
    assert card.inc.diameter(exact=True) == d_cpu


@pytest.mark.parametrize("mode", ["incremental", "full"])
def test_incremental_distances_on_card_held_to_scipy(cuda, mode):
    """C=1024 (the tiled rebuild, K2 + K1): an op stream of inserts,
    joins and leaves; after a refresh the live distances equal scipy's
    Dijkstra within the reference's tolerance, and before it the stale
    ones are lower bounds."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    from repro_torch.core.diameter import INF, adjacency_from_edges, \
        is_edge, ring_edges
    from repro_torch.dynamics import IncrementalDistances

    cap, n_live = 1024, 1000
    w = make_latency("bitnode", cap, seed=3)
    rng = np.random.default_rng(3)
    alive = np.zeros(cap, bool)
    alive[:n_live] = True
    adj = adjacency_from_edges(w, np.concatenate(
        [ring_edges(rng.permutation(n_live)) for _ in range(2)]))
    inc = IncrementalDistances(w, adj, alive, rebuild_threshold=6,
                               mode=mode)
    assert inc._dist.is_cuda
    before = dict(kernel.launches)
    for step in range(40):
        live = inc.live_ids()
        r = rng.random()
        if r < 0.6:
            u, v = rng.choice(live, size=2, replace=False)
            inc.add_edge(int(u), int(v))
        elif r < 0.8 and (~inc.alive).any():
            inc.join(int(np.flatnonzero(~inc.alive)[0]),
                     [int(x) for x in rng.choice(live, 3, replace=False)])
        else:
            inc.leave(int(rng.choice(live)))
    live = inc.live_ids()
    a = inc.adj[np.ix_(live, live)].astype(np.float64)
    want = dijkstra(csr_matrix(np.where(is_edge(a), a, 0.0)), directed=False)
    reach = np.isfinite(want)
    stale = inc.live_distances().astype(np.float64)
    assert (stale[reach] <= want[reach] * (1 + 1e-4) + 1e-3).all()
    inc.refresh()
    got = inc.live_distances()
    assert np.array_equal(got < float(INF) / 2, reach)
    np.testing.assert_allclose(got[reach], want[reach], rtol=1e-4, atol=1e-3)
    assert kernel.launches["fw_tile"] > before["fw_tile"]


# --- routing, hierarchies and the service (repro_torch.routing / hier /
# service) ---------------------------------------------------------------------

@pytest.mark.parametrize("ties", [False, True])
def test_route_pairs_on_card_bitwise_cpu(cuda, ties):
    """The card's walk against the CPU's and the host loop on the same
    numpy inputs, both policies, every workload; with ``ties`` every link
    weighs the same, so first-min ``argmin`` decides most hops."""
    from repro_torch import overlay, routing

    n = 512
    if ties:
        w = np.full((n, n), 7.0, np.float32)
        np.fill_diagonal(w, 0.0)
    else:
        w = make_latency("fabric", n, seed=5)
    with batcheval.eval_options(device="cpu"):
        ov = overlay.build("chord", w, seed=0)
        dist = ov.distances()
    adj, ring = ov.adjacency, ov.rings[0]
    for kind in routing.WORKLOADS:
        pairs = routing.sample_pairs(n, 2048, kind, seed=1)
        for policy in routing.POLICIES:
            card = routing.route_pairs(adj, dist, pairs, policy=policy,
                                       ring=ring)
            dev = routing.route_pairs(adj, torch.from_numpy(dist).to(cuda),
                                      pairs, policy=policy, ring=ring)
            with batcheval.eval_options(device="cpu"):
                cpu = routing.route_pairs(adj, dist, pairs, policy=policy,
                                          ring=ring)
            host = routing.route_pairs_host(adj, dist, pairs[:256],
                                            policy=policy, ring=ring)
            for f in ("hops", "latency", "success", "failed", "optimum",
                      "stretch"):
                a = getattr(card, f)
                for other in (cpu, dev):
                    assert np.array_equal(a, getattr(other, f),
                                          equal_nan=True), (kind, policy, f)
                assert np.array_equal(a[:256], getattr(host, f),
                                      equal_nan=True), (kind, policy, f)
            assert card.success.all(), (kind, policy)


def test_hier_build_on_card_equals_cpu(cuda):
    """``build_hier`` on a synthetic-geo world: the clusters' nearest
    rings on the card, the head ring's DGRO scored by K1.  The CPU side
    runs the card's APSP method (squaring), so the builds are equal."""
    from repro_torch.hier import build_hier, synthetic_geo

    lat = synthetic_geo(4096, seed=0)
    before = kernel.launches["minplus_acc"]
    card = build_hier(lat, seed=0)
    assert kernel.launches["minplus_acc"] > before
    with batcheval.eval_options(device="cpu", method="squaring"):
        cpu = build_hier(lat, seed=0)
    assert card.equals(cpu)
    assert card.to_json() == cpu.to_json()
    assert card.diameter_bound("ecc") == cpu.diameter_bound("ecc")


@pytest.mark.parametrize("policy", ["dgro", "dgro-hier"])
def test_service_state_on_card_routes_as_cpu(cuda, policy):
    """A ServiceState on the card and one on the CPU (the card's APSP
    method) ingest the same events and answer every route the same."""
    from repro_torch.dynamics import Trace, scenarios
    from repro_torch.service import ServiceState

    n0 = 200
    world = Trace(n0=n0, capacity=2 * n0, dist="bitnode", seed=3, events=[],
                  name="card-world")
    card = ServiceState.fresh(world, policy=policy, seed=0,
                              rebuild_threshold=4)
    assert card.device.type == "cuda"
    with batcheval.eval_options(method="squaring"):
        cpu = ServiceState.fresh(world, policy=policy, seed=0,
                                 rebuild_threshold=4, device="cpu")
    tr = scenarios.poisson_churn(n0=n0, seed=3, join_rate=2e-3,
                                 leave_rate=2e-3)
    events = sorted(tr.events, key=lambda e: e.time)[:40]
    rng = np.random.default_rng(0)
    for i in range(0, len(events), 8):
        card.ingest(events[i:i + 8])
        with batcheval.eval_options(method="squaring"):
            cpu.ingest(events[i:i + 8])
        live = card.adjacency()["nodes"]
        assert live == cpu.adjacency()["nodes"]
        for _ in range(8):
            a, b = rng.choice(live, size=2, replace=False)
            with batcheval.eval_options(method="squaring"):
                want = cpu.route(int(a), int(b))
            assert card.route(int(a), int(b)) == want


# --- the MoE layer -----------------------------------------------------------

@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_layer_on_card_matches_cpu(cuda, cf):
    """moonshot-v1-16b-a3b's MoE layer at full width, 1,024 tokens; at cf 0.5
    about half the copies are dropped.  A token routed to another expert set
    on the card must be a near tie (k-th / (k+1)-th probability gap <= 1e-6
    of the row's max); other drops may differ only beside such a flip;
    tokens dispatched alike agree within rtol 1e-4, atol 1e-5."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b"),
                              capacity_factor=cf)
    p = moe.init_moe(torch.Generator().manual_seed(2), cfg, torch.float32,
                     "cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (2, 512, cfg.d_model)).astype(np.float32))
    y, probs = moe.moe_apply({k: v.to(cuda) for k, v in p.items()},
                             x.to(cuda), cfg)
    yc, probsc = moe.moe_apply(p, x, cfg)
    a = moe.dispatch_codes(probs.cpu(), cfg)
    b = moe.dispatch_codes(probsc, cfg)
    flip = ((a > 0) != (b > 0)).any(-1)
    if flip.any():
        top = probsc.topk(cfg.top_k + 1, dim=-1).values
        gap = (top[:, -2] - top[:, -1]) / top[:, 0]
        assert float(gap[flip].max()) <= 1e-6
    else:
        assert torch.equal(a, b)
    if cf == 0.5:
        assert int((b == 1).sum()) > 0
    alike = ~(a != b).any(-1)
    assert int(alike.sum()) >= 1000
    torch.testing.assert_close(y.cpu().reshape(1024, -1)[alike],
                               yc.reshape(1024, -1)[alike], rtol=1e-4,
                               atol=1e-5)


def test_moe_layer_forward_and_backward_bitwise_on_card(cuda):
    """Two runs of moonshot's MoE layer (full width, cf 0.5 so that copies
    drop) give the same bits, output and every gradient: no atomics."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b"),
                              capacity_factor=0.5)
    p = moe.init_moe(torch.Generator(device=cuda).manual_seed(3), cfg,
                     torch.float32, cuda)
    x = torch.randn(2, 512, cfg.d_model, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(4))
    out = []
    for _ in range(2):
        ps = {k: v.clone().requires_grad_() for k, v in p.items()}
        xx = x.clone().requires_grad_()
        y, probs = moe.moe_apply(ps, xx, cfg)
        (y.square().mean() + moe.router_aux_loss(probs)).backward()
        out.append([y.detach(), xx.grad] + [ps[k].grad for k in sorted(ps)])
    assert all(torch.equal(u, v) for u, v in zip(*out))
    assert all(bool(g.any()) for g in out[0][1:])


def test_moe_train_step_grads_bitwise_and_remat_on_card(cuda):
    """moonshot smoke through the kernels on the card: two passes of the
    gradients and remat against none bitwise, and the kernels' loss and
    gradients against the plain path's."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import tree_leaves

    cfg = get_arch("moonshot-v1-16b-a3b").smoke()
    state = TT.init_state(cfg, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (4, 64))).to(cuda)
    batch = {"tokens": toks, "labels": toks}
    tc = TT.TrainConfig(remat=True)
    runs = [TT.loss_and_grads(cfg, c, state.params, batch) for c in
            (tc, tc, dataclasses.replace(tc, remat=False))]
    for loss, m, g in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert torch.equal(m["aux"], runs[0][1]["aux"])
        assert all(torch.equal(u, v) for u, v in
                   zip(tree_leaves(g), tree_leaves(runs[0][2])))
    loss, m, g = TT.loss_and_grads(cfg, tc, state.params, batch, impl="ref")
    assert float(m["aux"]) > 0
    torch.testing.assert_close(loss, runs[0][0], rtol=1e-5, atol=0)
    for u, v in zip(tree_leaves(runs[0][2]), tree_leaves(g)):
        assert bool(u.any())
        torch.testing.assert_close(u, v, rtol=1e-4,
                                   atol=1e-4 * float(v.abs().max()))


# --- K5 selective scan and the SSM layers ------------------------------------

def _scan_inputs(device, b, s, d, n, seed):
    """dt = softplus(N(-4.6, 1)) (the layers' dt_b: dt ~ 0.01), x, B, C and
    a nonzero h0 unit normals, A = -exp(log(1..N)) as the Mamba1 init."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    dt = torch.nn.functional.softplus(t(rng.normal(-4.6, 1.0, (b, s, d))))
    a = -t(np.broadcast_to(np.arange(1, n + 1, dtype=np.float32), (d, n)))
    return (dt, t(rng.normal(0, 1, (b, s, d))), t(rng.normal(0, 1, (b, s, n))),
            t(rng.normal(0, 1, (b, s, n))), a.contiguous(),
            t(rng.normal(0, 1, (b, d, n))))


@pytest.mark.parametrize("n", [1, 3, 8, 16])
@pytest.mark.parametrize("s", [1, 24, 256, 1024])
def test_selective_scan_matches_plain(cuda, n, s):
    """K5 against its plain version on the card: an odd batch, d = 200 (not
    a multiple of the 64-channel block), a nonzero h0, N = 1 and 3 padded
    to a state a lane.  y and h_last within 1e-5 x max |want| (fp32 sums
    over N in another order, FMAs, the decay by ex2.approx)."""
    from repro_torch.kernels.selective_scan import kernel as ss_kernel
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    ins = _scan_inputs(cuda, 3, s, 200, n, seed=s + n)
    before = ss_kernel.launches["selective_scan"]
    y, h = ss_ops.selective_scan(*ins)
    assert ss_kernel.launches["selective_scan"] == before + 1
    wy, wh = selective_scan_ref(*ins)
    for got, want in ((y, wy), (h, wh)):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) \
            <= 1e-5 * float(want.abs().max())
    y2, h2 = ss_ops.selective_scan(*ins)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.parametrize("n", [1, 3, 8, 16])
@pytest.mark.parametrize("s", [1, 24, 256, 1024])
def test_selective_scan_gated_matches_plain(cuda, n, s):
    """K5 with Mamba1's gate (D, z) against ``selective_scan_gated_ref`` on
    the card, as the scan-only test: odd batch, d = 200, nonzero h0, D and
    z unit normals; the gated output and h_last within 1e-5 x max |want|,
    and a repeat bitwise equal."""
    from repro_torch.kernels.selective_scan import kernel as ss_kernel
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.kernels.selective_scan.ref import \
        selective_scan_gated_ref

    ins = _scan_inputs(cuda, 3, s, 200, n, seed=s + n + 1)
    rng = np.random.default_rng(s * n)
    dskip = torch.from_numpy(rng.normal(0, 1, 200).astype(np.float32)) \
        .to(cuda)
    z = torch.from_numpy(rng.normal(0, 1, (3, s, 200)).astype(np.float32)) \
        .to(cuda)
    before = ss_kernel.launches["selective_scan"]
    y, h = ss_ops.selective_scan(*ins, dskip, z)
    assert ss_kernel.launches["selective_scan"] == before + 1
    wy, wh = selective_scan_gated_ref(*ins, dskip, z)
    for got, want in ((y, wy), (h, wh)):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) \
            <= 1e-5 * float(want.abs().max())
    y2, h2 = ss_ops.selective_scan(*ins, dskip, z)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.parametrize("gated", [False, True])
def test_selective_scan_odd_width_and_offset_views(cuda, gated):
    """K5 where its 16-byte copies do not apply: d = 61 (not a multiple of
    4), and the same inputs as views that start one element into a larger
    buffer (not 16-byte aligned); S = 23 ends inside a tile.  Against the
    plain versions within 1e-5 x max |want|."""
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.kernels.selective_scan.ref import (
        selective_scan_gated_ref, selective_scan_ref)

    ins = _scan_inputs(cuda, 3, 23, 61, 5, seed=61)
    rng = np.random.default_rng(61)
    gate = (torch.from_numpy(rng.normal(0, 1, 61).astype(np.float32))
            .to(cuda), torch.from_numpy(rng.normal(0, 1, (3, 23, 61))
                                        .astype(np.float32)).to(cuda))
    gate = gate if gated else ()
    plain = selective_scan_gated_ref if gated else selective_scan_ref
    want = plain(*ins, *gate)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=cuda)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    for args in ((*ins, *gate), tuple(shifted(t) for t in (*ins, *gate))):
        got = ss_ops.selective_scan(*args)
        for g, w in zip(got, want):
            assert bool(torch.isfinite(g).all())
            assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_selective_scan_grad_flows_and_refuses_what_it_does_not_take(cuda):
    """Under autograd K5 runs with its saved states and K5b gives every
    input that needs one a gradient (h0 none); with grad off it is the
    serving call, bitwise the same output.  What neither kernel takes
    raises ``ValueError``."""
    from repro_torch.kernels.selective_scan import kernel as ss_kernel
    from repro_torch.kernels.selective_scan import ops as ss_ops

    dt, x, bm, cm, a, h0 = _scan_inputs(cuda, 2, 16, 64, 8, seed=1)
    dskip, z = torch.ones(64, device=cuda), torch.ones(2, 16, 64,
                                                        device=cuda)
    with torch.no_grad():
        served = ss_ops.selective_scan(dt, x, bm, cm, a, h0, dskip, z)
    leaves = [t.clone().requires_grad_() for t in (dt, x, bm, cm, a)]
    before = dict(ss_kernel.launches)
    y, h = ss_ops.selective_scan(*leaves, h0, dskip, z)
    assert torch.equal(y, served[0]) and torch.equal(h, served[1])
    grads = torch.autograd.grad(y.sum(), leaves)
    assert ss_kernel.launches["selective_scan"] == \
        before["selective_scan"] + 1
    assert ss_kernel.launches["selective_scan_bwd"] == \
        before["selective_scan_bwd"] + 1
    assert all(bool(torch.isfinite(g).all()) and bool(g.any())
               for g in grads)
    with pytest.raises(ValueError, match="contiguous fp32"):
        ss_ops.selective_scan(dt.double(), x, bm, cm, a, h0)
    with pytest.raises(ValueError, match="contiguous fp32"):
        ss_ops.selective_scan(dt.transpose(0, 1).contiguous().transpose(
            0, 1), x, bm, cm, a, h0)
    with pytest.raises(ValueError, match="'z'"):
        ss_ops.selective_scan(dt, x, bm, cm, a, h0, dskip, z[:, :8])
    with pytest.raises(ValueError, match="'D'"):
        ss_ops.selective_scan(dt, x, bm, cm, a, h0, dskip[:32], z)
    with pytest.raises(ValueError, match="both D and z"):
        ss_ops.selective_scan(dt, x, bm, cm, a, h0, dskip, None)
    with pytest.raises(ValueError, match="contiguous fp32"):
        ss_ops.selective_scan(dt, x, bm, cm, a, h0, dskip, z.double())
    with pytest.raises(ValueError, match="saved states"):
        ss_kernel.selective_scan_bwd(dt, x, bm, cm, a, h0, None, x)
    _, _, hs = ss_kernel.selective_scan(dt, x, bm, cm, a, h0, states=True)
    with pytest.raises(ValueError, match="contiguous fp32"):
        ss_kernel.selective_scan_bwd(dt, x, bm, cm, a, h0, hs,
                                     x.transpose(1, 2).contiguous()
                                     .transpose(1, 2))
    with pytest.raises(ValueError, match="cotangents"):
        ss_kernel.selective_scan_bwd(dt, x, bm, cm, a, h0, hs, x[:, :8])
    n = 17
    with pytest.raises(ValueError, match="N <= 16"):
        ss_ops.selective_scan(dt, x, torch.zeros(2, 16, n, device=cuda),
                              torch.zeros(2, 16, n, device=cuda),
                              torch.zeros(64, n, device=cuda),
                              torch.zeros(2, 64, n, device=cuda))


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("s", [1, 17, 130, 1024])
def test_selective_scan_states_leave_the_output_bitwise(cuda, s, gated):
    """K5 with its saved states (the training forward) writes bitwise the
    serving call's output and last state; its first saved state is h0 and
    the k-th the plain scan's state after step 16 k - 1, within 1e-5 x max
    |want|."""
    from repro_torch.kernels.selective_scan import kernel as ss_kernel
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    ins = _scan_inputs(cuda, 3, s, 200, 5, seed=s)
    gate = (torch.randn(200, device=cuda), torch.randn(3, s, 200,
                                                       device=cuda)) \
        if gated else ()
    y, h = ss_kernel.selective_scan(*ins, *gate)
    y2, h2, hs = ss_kernel.selective_scan(*ins, *gate, states=True)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert hs.shape == (3, -(-s // 16), 200, 5)
    assert torch.equal(hs[:, 0], ins[5])
    for k in range(1, hs.shape[1]):
        _, want = selective_scan_ref(*(t[:, :16 * k] for t in ins[:4]),
                                     ins[4], ins[5])
        assert float((hs[:, k] - want).abs().max()) \
            <= 1e-5 * float(want.abs().max())


# K5b's gradients, each held to 1e-5 x its max |want| (the forward's
# tolerance; the sums over channels and steps measured within 3e-6 on the
# card, so none is loosened)
BWD_NAMES = ("ddt", "dx", "dB", "dC", "dA", "dh0", "dD", "dz")


def _bwd_case(cuda, b, s, d, n, gated, seed):
    from repro_torch.kernels.selective_scan import kernel as ss_kernel

    ins = _scan_inputs(cuda, b, s, d, n, seed)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    gate = (torch.randn(d, generator=gen, device=cuda),
            torch.randn((b, s, d), generator=gen, device=cuda)) \
        if gated else ()
    dout = torch.randn((b, s, d), generator=gen, device=cuda)
    dh_last = torch.randn((b, d, n), generator=gen, device=cuda)
    _, _, hs = ss_kernel.selective_scan(*ins, *gate, states=True)
    return ins, gate, hs, dout, dh_last


def _bwd_close(got, want, names=BWD_NAMES):
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert bool(torch.isfinite(g).all()), name
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (name, err)


# (S, N, d): a whole tile (16) and tiles cut short (1, 17, 130, whose
# chunk of 128 is cut short too); N = 1, 3 and 5 padded to a power of two
# a lane and N = 4 and 16 not, at 4 or 8 lanes a channel; d = 200, not a
# multiple of a block of channels; and falcon-mamba-7b's d = 8192 at a
# small S, the real grid of blocks
BWD_SHAPES = [(s, n, 200) for s in (1, 16, 17, 130)
              for n in (1, 3, 4, 5, 16)] + [(33, 16, 8192)]


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("s,n,d", BWD_SHAPES)
def test_selective_scan_bwd_matches_plain(cuda, s, n, d, gated):
    """K5b against ``selective_scan_bwd_ref`` on the card at ragged shapes
    (``BWD_SHAPES``), an odd batch, nonzero h0 and dh_last; every gradient
    within 1e-5 x its max |want|."""
    from repro_torch.kernels.selective_scan import kernel as ss_kernel
    from repro_torch.kernels.selective_scan.ref import selective_scan_bwd_ref

    ins, gate, hs, dout, dh_last = _bwd_case(cuda, 3, s, d, n, gated,
                                             seed=s * n + gated)
    before = ss_kernel.launches["selective_scan_bwd"]
    got = ss_kernel.selective_scan_bwd(*ins, hs, dout, dh_last, *gate)
    assert ss_kernel.launches["selective_scan_bwd"] == before + 1
    assert len(got) == (8 if gated else 6)
    _bwd_close(got, selective_scan_bwd_ref(*ins, dout, dh_last, *gate))
    none = ss_kernel.selective_scan_bwd(*ins, hs, dout, None, *gate)
    _bwd_close(none, selective_scan_bwd_ref(*ins, dout, None, *gate))


@pytest.mark.parametrize("gated", [False, True])
def test_selective_scan_bwd_repeats_bitwise(cuda, gated):
    """Two K5b calls give bitwise the same gradients: no atomics, the
    channel and batch partials summed in a fixed order."""
    from repro_torch.kernels.selective_scan import kernel as ss_kernel

    ins, gate, hs, dout, dh_last = _bwd_case(cuda, 4, 300, 520, 16, gated,
                                             seed=9)
    first = ss_kernel.selective_scan_bwd(*ins, hs, dout, dh_last, *gate)
    again = ss_kernel.selective_scan_bwd(*ins, hs, dout, dh_last, *gate)
    assert all(torch.equal(u, v) for u, v in zip(first, again))


def test_selective_scan_function_grads_match_autograd_of_plain(cuda):
    """The autograd Function on the card (K5 with its states, K5b) against
    torch autograd through ``selective_scan_gated_ref`` on the card, h0
    without a gradient and h_last unused, as training calls it."""
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.kernels.selective_scan.ref import \
        selective_scan_gated_ref

    ins, gate, _, dout, _ = _bwd_case(cuda, 2, 256, 200, 16, True, seed=3)
    grads = []
    for fwd in (ss_ops.selective_scan, selective_scan_gated_ref):
        leaves = [t.clone().requires_grad_() for t in (*ins[:5], *gate)]
        y, _ = fwd(*leaves[:5], ins[5], *leaves[5:])
        grads.append(torch.autograd.grad(y, leaves, dout))
    _bwd_close(*grads, names=("ddt", "dx", "dB", "dC", "dA", "dD", "dz"))


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "zamba2-7b"])
def test_ssm_layer_on_card_matches_cpu(fp32_matmul, name):
    """One Mamba1 (falcon-mamba-7b, through K5) or Mamba2 (zamba2-7b,
    through K3's gate norm) layer at full width, B = 2, S = 128, then one
    decode step from its state, on the card against the CPU port: outputs
    and states within 1e-5 x max |want| (fp32 products summed in another
    order).  A Mamba1 layer runs K5 in both: gated over the sequence, and
    at S = 1 for the step."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.selective_scan import kernel as ss_kernel
    from repro_torch.models import mamba

    cuda = fp32_matmul
    cfg = get_arch(name)
    m1 = cfg.ssm_kind == "mamba1"
    init = mamba.init_mamba1 if m1 else mamba.init_mamba2
    apply = mamba.mamba1_apply if m1 else mamba.mamba2_apply
    step = mamba.mamba1_step if m1 else mamba.mamba2_step
    p = init(torch.Generator().manual_seed(5), cfg, torch.float32, "cpu")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 1, (2, 129, cfg.d_model))
                         .astype(np.float32))
    pc = {k: v.to(cuda) for k, v in p.items()}
    before = ss_kernel.launches["selective_scan"]
    with torch.no_grad():
        got = apply(pc, x[:, :128].to(cuda), cfg)
        want = apply(p, x[:, :128], cfg)
        got1 = step(pc, x[:, 128].to(cuda), cfg, got[1])
        want1 = step(p, x[:, 128], cfg, want[1])
    assert ss_kernel.launches["selective_scan"] == before + 2 * int(m1)
    for g, w in ((got[0], want[0]), (got[1][0], want[1][0]),
                 (got[1][1], want[1][1]), (got1[0], want1[0]),
                 (got1[1][0], want1[1][0]), (got1[1][1], want1[1][1])):
        assert bool(torch.isfinite(g).all())
        assert float((g.cpu() - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "zamba2-7b"])
def test_ssm_loss_and_grads_on_card_match_cpu(fp32_matmul, name):
    """falcon-mamba-7b smoke (K5 / K5b) and zamba2-7b smoke (K3 / K3b and
    K4 / K4b in its shared block) trained on the card against the CPU
    port: the loss within rel 1e-5, every leaf's gradient within 1e-4 x
    its max |g_cpu| and nonzero; two passes and remat against none
    bitwise.  With remat, a Mamba1 layer runs K5 twice and K5b once."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.selective_scan import kernel as ss_kernel
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import tree_leaves, tree_like

    cuda = fp32_matmul
    cfg = get_arch(name).smoke()
    state = TT.init_state(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (4, 64)))
    batch = {"tokens": toks, "labels": toks}
    card = tree_like(state.params, [p.to(cuda)
                                    for p in tree_leaves(state.params)])
    cbatch = {k: v.to(cuda) for k, v in batch.items()}
    tc = TT.TrainConfig(remat=True)
    before = dict(ss_kernel.launches)
    runs = [TT.loss_and_grads(cfg, c, card, cbatch) for c in
            (tc, tc, dataclasses.replace(tc, remat=False))]
    mamba1 = cfg.n_layers if cfg.ssm_kind == "mamba1" else 0
    assert ss_kernel.launches["selective_scan"] - \
        before["selective_scan"] == 5 * mamba1
    assert ss_kernel.launches["selective_scan_bwd"] - \
        before["selective_scan_bwd"] == 3 * mamba1
    for loss, _, g in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(u, v) for u, v in
                   zip(tree_leaves(g), tree_leaves(runs[0][2])))
    loss, _, g = TT.loss_and_grads(cfg, tc, state.params, batch)
    torch.testing.assert_close(runs[0][0].cpu(), loss, rtol=1e-5, atol=0)
    for u, v in zip(tree_leaves(runs[0][2]), tree_leaves(g)):
        assert bool(u.any())
        torch.testing.assert_close(u.cpu(), v, rtol=1e-4,
                                   atol=1e-4 * float(v.abs().max()))


# --- K6: decode attention over a KV cache in its stored dtype ---------------

CACHE_DTYPES = [torch.float32, torch.bfloat16, torch.float8_e4m3fn]


def _decode_sizes(d: int, dtype) -> list:
    """S of the K6 checks: ragged and served sizes, and both sides of the
    tile edge and of each step of the cluster size the launch rule can
    take for this width and dtype, at either number of warps a CTA."""
    from repro_torch.kernels.decode_attention import kernel as da

    ts = da.tile(d, torch.empty((), dtype=dtype).element_size())
    sizes = {1, 17, 512, 1312, ts - 1, ts, ts + 1}
    for w in da.WARPS:
        c = 1
        while 2 * c <= da.CLUSTER_MAX:
            c *= 2
            edge = c * w * ts           # the first S that allows c CTAs of w
            sizes |= {edge - 1, edge, edge + 1}
    return sorted(x for x in sizes if x >= 1)


@pytest.mark.parametrize("g", [1, 2, 4, 5])
@pytest.mark.parametrize("dtype", CACHE_DTYPES, ids=["fp32", "bf16", "fp8"])
@pytest.mark.parametrize("d", [64, 112, 128, 256])
def test_decode_attention_matches_plain(cuda, d, dtype, g):
    """K6 against its plain twin for every D instance (DP 64, 128, 128,
    256), cache dtype and GQA group, S ragged, served and on both sides of
    the tile and cluster-size edges (:func:`_decode_sizes`), global and
    local (window 16), a cache partly written, full and wrapped: within
    1e-5 x max |want| (fp32 online against dense softmax), and two calls
    bitwise (a fixed merge order, no atomics)."""
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.layers import to_cache_dtype

    rng = np.random.default_rng(d * 10 + g)
    b, hkv = 3, 2
    for s in _decode_sizes(d, dtype):
        q = torch.from_numpy(rng.normal(0, 1, (b, hkv * g, 1, d))
                             .astype(np.float32)).to(cuda)
        k, v = (to_cache_dtype(torch.from_numpy(
            rng.normal(0, 2, (b, hkv, s, d)).astype(np.float32)).to(cuda),
            dtype) for _ in range(2))
        for window in (None, 16):
            for pos in sorted({0, s // 2, s - 1, s + 5}):
                before = da.launches["decode_attention"]
                got = da.decode_attention(q, k, v, pos, window)
                assert da.launches["decode_attention"] == before + 1
                want = decode_attention_ref(q, k, v, pos, window)
                assert got.dtype == torch.float32
                assert got.shape == (b, hkv * g, 1, d)
                err = float((got - want).abs().max())
                assert err <= 1e-5 * float(want.abs().max()), \
                    (s, window, pos, err)
                assert torch.equal(got, da.decode_attention(q, k, v, pos,
                                                            window))


@pytest.mark.parametrize("dtype", CACHE_DTYPES[1:], ids=["bf16", "fp8"])
@pytest.mark.parametrize("s,pos,window", [(1312, 700, None),
                                          (512, 1055, 300),
                                          (8192, 5000, None)])
def test_decode_attention_never_reads_dead_slots(cuda, dtype, s, pos,
                                                 window):
    """NaN bytes in every dead slot of a bf16 / fp8 cache (unwritten past
    pos, or out of the window of a rolled local cache) leave K6's output
    finite and bitwise equal to its output with zeros there: the kernel
    stages those slots as zeros without reading them (an old fp8 row past
    464 is NaN, and 0 x NaN would be NaN)."""
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.models.layers import to_cache_dtype

    rng = np.random.default_rng(s + pos)
    b, hkv, g, d = 2, 8, 4, 128
    q = torch.from_numpy(rng.normal(0, 1, (b, hkv * g, 1, d))
                         .astype(np.float32)).to(cuda)
    k, v = (to_cache_dtype(torch.from_numpy(
        rng.normal(0, 2, (b, hkv, s, d)).astype(np.float32)).to(cuda), dtype)
        for _ in range(2))
    i = torch.arange(s, device=cuda)
    back = torch.remainder(pos % s - i, s)          # steps back from pos
    dead = (back > pos) | (back >= window if window else False)
    assert bool(dead.any()) and not bool(dead.all())
    # through integer views: the bits of a NaN (0x7f e4m3, 0x7fc0 bf16)
    bits, nan = (torch.uint8, 0x7f) if dtype == torch.float8_e4m3fn \
        else (torch.int16, 0x7fc0)
    clean = []
    for x in (k, v):
        x.view(bits)[:, :, dead] = 0
        clean.append(x.clone())
    want = da.decode_attention(q, *clean, pos, window)
    for x in (k, v):
        x.view(bits)[:, :, dead] = nan
    assert bool(k.float().isnan().any())
    got = da.decode_attention(q, k, v, pos, window)
    assert bool(got.isfinite().all())
    assert torch.equal(got, want)


def test_decode_attention_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.decode_attention import kernel as da

    q = torch.zeros((1, 6, 1, 64), device=cuda)
    k = torch.zeros((1, 2, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="Hq / Hkv"):
        da.decode_attention(q, k, k, 3)                 # g = 3
    with pytest.raises(ValueError, match="contiguous"):
        kt = torch.zeros((1, 2, 64, 8), device=cuda).transpose(2, 3)
        da.decode_attention(q[:, :4], kt, kt, 3)
    with pytest.raises(ValueError, match="fp32, bf16"):
        kh = k.half()
        da.decode_attention(q[:, :4], kh, kh, 3)
    with pytest.raises(ValueError, match="D <= 256"):
        qq = torch.zeros((1, 2, 1, 320), device=cuda)
        kk = torch.zeros((1, 2, 8, 320), device=cuda)
        da.decode_attention(qq, kk, kk, 3)


def test_fp8_cast_on_card_is_bitwise_the_cpu_cast(cuda):
    """``layers.to_cache_dtype`` on a CUDA tensor gives the CPU's bytes
    (and so the JAX package's, ``tests/test_torch_fp8_cache.py``) over
    normals at several scales, every 4099th fp32 bit pattern and the
    values around +-464, 448 and the subnormals."""
    from repro_torch.models.layers import to_cache_dtype

    rng = np.random.default_rng(0)
    base = np.array([464, 448, 480, 2.0 ** -6, 2.0 ** -9, 2.0 ** -10],
                    np.float32)
    near = (base.view(np.int32)[:, None] + np.arange(-64, 65)[None]) \
        .astype(np.int32).view(np.float32).ravel()
    x = np.concatenate([near, -near, *[rng.normal(0, s, 50000).astype(
        np.float32) for s in (1e-3, 1.0, 600.0)], np.arange(
        0, 2 ** 32, 4099, dtype=np.uint64).astype(np.uint32)
        .view(np.float32)])
    t = torch.from_numpy(x)
    got = to_cache_dtype(t.to(cuda), torch.float8_e4m3fn).view(torch.uint8)
    want = to_cache_dtype(t, torch.float8_e4m3fn).view(torch.uint8)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name,cache", [
    ("pixtral-12b", torch.float8_e4m3fn), ("pixtral-12b", torch.float32),
    ("musicgen-large", torch.float32), ("gemma3-1b", torch.bfloat16),
    ("zamba2-7b", torch.float8_e4m3fn)])
def test_generate_on_card_matches_cpu(fp32_matmul, name, cache):
    """Smoke serving on the card (K3, K4, K6; the vision stub's patches
    for pixtral) against the CPU port on the same cache dtype: an fp8 or
    bf16 cache within one step of its type (a value a last bit from a
    rounding midpoint rounds apart when the fp32 sums differ in order);
    prefill and every decode step's logits and the fp32 leaves of the
    caches within rtol = atol = 1e-4, 1e-3 beside an fp8 cache (one such
    code an e4m3 step, 1/8 of its value, away moves zamba2's smoke logits
    and later conv states by ~1e-4: 1.21e-4 and 1.42e-4 measured); and K6
    launched once per attention layer (or shared call) per decode step."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.models import model as TM
    from repro_torch.models.convert import flatten
    from repro_torch.launch.serve import patch_embeddings

    cuda = fp32_matmul
    cfg = get_arch(name).smoke()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (2, 20)))
    vis = patch_embeddings(cfg, 2, "cpu") if cfg.frontend == "vision" \
        else None
    n_vis = 0 if vis is None else vis.shape[1]
    out = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        caches = TM.init_caches(cfg, 2, n_vis + 26, cache, device=dev)
        before = da.launches["decode_attention"]
        logits, caches, _ = TM.forward(
            cfg, p, toks[:, :16].to(dev), mode="prefill", caches=caches,
            vision_embeds=None if vis is None else vis.to(dev))
        steps = [logits.cpu()]
        for i in range(16, 20):
            logits, caches = TM.forward(cfg, p, toks[:, i:i + 1].to(dev),
                                        mode="decode", caches=caches,
                                        pos=n_vis + i)
            steps.append(logits.cpu())
        out[str(dev)] = (steps, flatten(caches),
                         da.launches["decode_attention"] - before)
    cpu, card = out["cpu"], out[str(cuda)]
    per = TM.pattern_period(cfg)
    attn = sum(TM.layer_kind(cfg, i % per).get("shared_attn", True)
               for i in range(cfg.n_layers))
    assert cpu[2] == 0 and card[2] == 4 * attn
    tol = 1e-3 if cache == torch.float8_e4m3fn else 1e-4
    for g, w in zip(card[0], cpu[0]):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    for key, w in cpu[1].items():
        g = card[1][key].cpu()
        assert g.dtype == w.dtype, key
        if w.dtype == torch.float8_e4m3fn:
            diff = g.view(torch.uint8).short() - w.view(torch.uint8).short()
        elif w.dtype == torch.bfloat16:
            diff = g.view(torch.int16).int() - w.view(torch.int16).int()
        else:
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
            continue
        assert int(diff.abs().max()) <= 1, key


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}
