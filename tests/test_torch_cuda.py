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
    """The three variants of K3 are chosen as documented, and each holds."""
    x = torch.randn(64, 301, device=cuda)               # row stride 301
    s = torch.randn(301, device=cuda) * 0.1
    cases = {
        "warp": (x[:, :256].contiguous(), s[:256].contiguous()),
        "loop": (torch.randn(9, 4096, device=cuda),
                 torch.randn(4096, device=cuda) * 0.1),
        "scalar": (x[:, :256], s[:256].contiguous()),
    }
    for kind, (xx, ss) in cases.items():
        assert rn_kernel.variant(xx, ss)[0] == kind
        before = rn_kernel.launches["rmsnorm"]
        assert rmsnorm_close(rn_kernel.rmsnorm_rows(xx, ss),
                             rmsnorm_ref(xx, ss))
        assert rn_kernel.launches["rmsnorm"] == before + 1


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


# --- the churn engine (repro_torch.dynamics) ----------------------------------

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
